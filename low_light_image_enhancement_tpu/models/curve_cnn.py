"""Zero-DCE-style curve-estimation CNN (BASELINE.json config 3).

Seven 3x3 convs with U-style skip concatenations; the head emits
``3 * n_iter`` tanh-bounded per-pixel curve parameter maps that drive
``ops.curves.apply_curves``. Pure functional: ``init_curve_cnn`` returns a
param pytree, ``apply_curve_cnn`` is jit/pjit-friendly.

Convs run in NHWC; the planar (C,H,W) pipeline layout is transposed at
entry/exit. Compute dtype is configurable — bfloat16 inputs with float32
accumulation (``preferred_element_type``) is the default.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp

from low_light_image_enhancement_tpu.models.layers import conv2d

Params = Dict[str, Dict[str, jnp.ndarray]]


def init_curve_cnn(
    key: jax.Array, features: int = 32, n_iter: int = 8
) -> Params:
    """He-normal initialized parameters for the 7-conv curve estimator."""
    sizes = [
        (3, features),                 # c1
        (features, features),          # c2
        (features, features),          # c3
        (features, features),          # c4
        (2 * features, features),      # c5 (cat x3, x4)
        (2 * features, features),      # c6 (cat x2, x5)
        (2 * features, 3 * n_iter),    # c7 (cat x1, x6)
    ]
    params: Params = {}
    keys = jax.random.split(key, len(sizes))
    for i, ((cin, cout), k) in enumerate(zip(sizes, keys), start=1):
        fan_in = 3 * 3 * cin
        w = jax.random.normal(k, (3, 3, cin, cout), jnp.float32)
        w = w * jnp.sqrt(2.0 / fan_in)
        params[f"c{i}"] = {"w": w, "b": jnp.zeros((cout,), jnp.float32)}
    return params


def apply_curve_cnn(
    params: Params,
    x: jnp.ndarray,
    n_iter: int = 8,
    compute_dtype: jnp.dtype = jnp.float32,
) -> jnp.ndarray:
    """(..., 3, H, W) in [0,1] -> curve maps (..., n_iter, 3, H, W) in [-1,1]."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    nhwc = jnp.transpose(x, (0, 2, 3, 1))  # (B, H, W, 3)

    def cv(name, h):
        return conv2d(h, params[name]["w"], params[name]["b"], compute_dtype)

    x1 = jax.nn.relu(cv("c1", nhwc))
    x2 = jax.nn.relu(cv("c2", x1))
    x3 = jax.nn.relu(cv("c3", x2))
    x4 = jax.nn.relu(cv("c4", x3))
    x5 = jax.nn.relu(cv("c5", jnp.concatenate([x3, x4], axis=-1)))
    x6 = jax.nn.relu(cv("c6", jnp.concatenate([x2, x5], axis=-1)))
    a = jnp.tanh(cv("c7", jnp.concatenate([x1, x6], axis=-1)))
    a = a.astype(jnp.float32)  # (B, H, W, 3*it); curves applied in f32

    b, h, w, _ = a.shape
    # reshape only on leading dims — a (B,H,W,it,3) intermediate would put
    # (it, 3) in the tiled minor dims and cost XLA a >4x padding blowup
    a = jnp.transpose(a, (0, 3, 1, 2)).reshape(b, n_iter, 3, h, w)
    return a if batched else a[0]


def apply_curve_cnn_gemm(
    params: Params,
    x: jnp.ndarray,
    n_iter: int = 8,
    compute_dtype: jnp.dtype = jnp.float32,
) -> jnp.ndarray:
    """Patch-GEMM variant of :func:`apply_curve_cnn` (same signature, same
    math to f32 rounding). All seven 3x3 convs run as 2x2-output-block
    GEMMs (K = 16*Cin, N = 4*Cout) on space-to-depth packed activations;
    the image is packed once on entry and unpacked once at exit
    (ops/patch_conv.py)."""
    from low_light_image_enhancement_tpu.ops.patch_conv import (
        conv2d_patch_gemm,
        depth_to_space,
        pack_bias,
        pack_patch_weights,
        space_to_depth,
    )

    batched = x.ndim == 4
    if not batched:
        x = x[None]
    f = params["c1"]["w"].shape[-1]
    nhwc = jnp.transpose(x, (0, 2, 3, 1))
    xp = space_to_depth(nhwc).astype(compute_dtype)

    def cv(name, h, groups):
        p = params[name]
        return conv2d_patch_gemm(
            h, pack_patch_weights(p["w"], groups=groups), pack_bias(p["b"]),
            compute_dtype, groups=groups,
        )

    x1 = jax.nn.relu(cv("c1", xp, (3,)))
    x2 = jax.nn.relu(cv("c2", x1, (f,)))
    x3 = jax.nn.relu(cv("c3", x2, (f,)))
    x4 = jax.nn.relu(cv("c4", x3, (f,)))
    x5 = jax.nn.relu(cv("c5", jnp.concatenate([x3, x4], -1), (f, f)))
    x6 = jax.nn.relu(cv("c6", jnp.concatenate([x2, x5], -1), (f, f)))
    a = jnp.tanh(cv("c7", jnp.concatenate([x1, x6], -1), (f, f)))
    a = depth_to_space(a).astype(jnp.float32)  # (B, H, W, 3*it)

    b, h, w, _ = a.shape
    a = jnp.transpose(a, (0, 3, 1, 2)).reshape(b, n_iter, 3, h, w)
    return a if batched else a[0]


def apply_curve_cnn_packed(
    params: Params,
    x: jnp.ndarray,
    n_iter: int = 8,
    compute_dtype: jnp.dtype = jnp.bfloat16,
    block: tuple = (2, 2),
) -> jnp.ndarray:
    """Space-to-depth block-conv variant of :func:`apply_curve_cnn`: the
    32-channel core runs as plain XLA convs on packed activations (128
    channels vs 32 — ops.patch_conv.pack_block_conv_weights), the 3-channel
    stem as a normal conv. Pure XLA, differentiable; an explicit
    ``conv_impl="packed"`` choice."""
    from low_light_image_enhancement_tpu.models.layers import conv2d
    from low_light_image_enhancement_tpu.ops.patch_conv import (
        conv2d_block_xla,
        depth_to_space,
        pack_block_conv_weights,
        space_to_depth,
    )

    batched = x.ndim == 4
    if not batched:
        x = x[None]
    f = params["c1"]["w"].shape[-1]
    nhwc = jnp.transpose(x, (0, 2, 3, 1))

    def cv(name, h, groups, act):
        p = params[name]
        y = conv2d_block_xla(
            h, pack_block_conv_weights(p["w"], groups=groups, block=block),
            p["b"], compute_dtype,
        )
        return act(y)

    p1 = params["c1"]
    x1 = space_to_depth(
        jax.nn.relu(conv2d(nhwc, p1["w"], p1["b"], compute_dtype)), block
    )
    x2 = cv("c2", x1, (f,), jax.nn.relu)
    x3 = cv("c3", x2, (f,), jax.nn.relu)
    x4 = cv("c4", x3, (f,), jax.nn.relu)
    x5 = cv("c5", jnp.concatenate([x3, x4], -1), (f, f), jax.nn.relu)
    x6 = cv("c6", jnp.concatenate([x2, x5], -1), (f, f), jax.nn.relu)
    a = cv("c7", jnp.concatenate([x1, x6], -1), (f, f), jnp.tanh)
    a = depth_to_space(a, block).astype(jnp.float32)

    b, h, w, _ = a.shape
    a = jnp.transpose(a, (0, 3, 1, 2)).reshape(b, n_iter, 3, h, w)
    return a if batched else a[0]


@dataclasses.dataclass(frozen=True)
class CurveEstimatorCNN:
    """Convenience object bundling architecture hyperparams with init/apply."""

    features: int = 32
    n_iter: int = 8
    compute_dtype: jnp.dtype = jnp.float32

    def init(self, key: jax.Array) -> Params:
        return init_curve_cnn(key, self.features, self.n_iter)

    def apply(self, params: Params, x: jnp.ndarray) -> jnp.ndarray:
        return apply_curve_cnn(params, x, self.n_iter, self.compute_dtype)
