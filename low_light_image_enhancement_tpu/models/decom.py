"""Learned Retinex decomposition net (RetinexNet-style DecomNet).

Maps an RGB image to (reflectance R in [0,1]^3, illumination L in [0,1]^1).
Provided as the learned counterpart to ``ops.retinex`` (cf. Retinex-RAWMamba's
decomposition stage, PAPERS.md:5). Functional init/apply like curve_cnn.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp

from low_light_image_enhancement_tpu.models.layers import conv2d

Params = Dict[str, Dict[str, jnp.ndarray]]


def init_decom_net(key: jax.Array, features: int = 32) -> Params:
    # Input = RGB plus its channel-max (4 channels), a standard DecomNet cue.
    sizes = [(4, features), (features, features), (features, features),
             (features, features), (features, 4)]
    params: Params = {}
    keys = jax.random.split(key, len(sizes))
    for i, ((cin, cout), k) in enumerate(zip(sizes, keys), start=1):
        fan_in = 3 * 3 * cin
        w = jax.random.normal(k, (3, 3, cin, cout), jnp.float32)
        w = w * jnp.sqrt(2.0 / fan_in)
        params[f"c{i}"] = {"w": w, "b": jnp.zeros((cout,), jnp.float32)}
    return params


def apply_decom_net(
    params: Params,
    x: jnp.ndarray,
    compute_dtype: jnp.dtype = jnp.float32,
):
    """(..., 3, H, W) -> (R: (..., 3, H, W), L: (..., 1, H, W)), both in [0,1]."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    mx = jnp.max(x, axis=1, keepdims=True)
    nhwc = jnp.transpose(jnp.concatenate([x, mx], axis=1), (0, 2, 3, 1))

    h = nhwc
    for i in range(1, 5):
        h = jax.nn.relu(conv2d(h, params[f"c{i}"]["w"], params[f"c{i}"]["b"],
                               compute_dtype))
    out = jax.nn.sigmoid(conv2d(h, params["c5"]["w"], params["c5"]["b"],
                                compute_dtype)).astype(jnp.float32)
    out = jnp.transpose(out, (0, 3, 1, 2))  # (B, 4, H, W)
    r, l = out[:, :3], out[:, 3:4]
    return (r, l) if batched else (r[0], l[0])


def apply_decom_net_gemm(
    params: Params,
    x: jnp.ndarray,
    compute_dtype: jnp.dtype = jnp.float32,
):
    """Patch-GEMM variant of :func:`apply_decom_net` (same signature,
    same math to f32 rounding); all five 3x3 convs run as 2x2-output-block
    GEMMs on space-to-depth packed activations (ops/patch_conv.py)."""
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
    mx = jnp.max(x, axis=1, keepdims=True)
    nhwc = jnp.transpose(jnp.concatenate([x, mx], axis=1), (0, 2, 3, 1))
    h = space_to_depth(nhwc).astype(compute_dtype)

    def cv(name, t):
        p = params[name]
        return conv2d_patch_gemm(
            t, pack_patch_weights(p["w"]), pack_bias(p["b"]), compute_dtype
        )

    for i in range(1, 5):
        h = jax.nn.relu(cv(f"c{i}", h))
    out = jax.nn.sigmoid(depth_to_space(cv("c5", h))).astype(jnp.float32)
    out = jnp.transpose(out, (0, 3, 1, 2))  # (B, 4, H, W)
    r, l = out[:, :3], out[:, 3:4]
    return (r, l) if batched else (r[0], l[0])


def apply_decom_net_packed(
    params: Params,
    x: jnp.ndarray,
    compute_dtype: jnp.dtype = jnp.bfloat16,
    block: tuple = (2, 2),
):
    """Space-to-depth block-conv variant of :func:`apply_decom_net`: the
    32-channel core runs as plain XLA convs on packed activations (128 full
    lanes — ops.patch_conv.pack_block_conv_weights); the 4-channel stem and
    head stay normal convs. Pure XLA, differentiable."""
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
    mx = jnp.max(x, axis=1, keepdims=True)
    nhwc = jnp.transpose(jnp.concatenate([x, mx], axis=1), (0, 2, 3, 1))
    p1 = params["c1"]
    h = jax.nn.relu(conv2d(nhwc, p1["w"], p1["b"], compute_dtype))
    h = space_to_depth(h, block)
    for i in range(2, 5):
        p = params[f"c{i}"]
        h = jax.nn.relu(
            conv2d_block_xla(
                h, pack_block_conv_weights(p["w"], block=block), p["b"],
                compute_dtype
            )
        )
    p5 = params["c5"]
    out = jax.nn.sigmoid(
        conv2d(depth_to_space(h, block), p5["w"], p5["b"], compute_dtype)
    ).astype(jnp.float32)
    out = jnp.transpose(out, (0, 3, 1, 2))  # (B, 4, H, W)
    r, l = out[:, :3], out[:, 3:4]
    return (r, l) if batched else (r[0], l[0])


@dataclasses.dataclass(frozen=True)
class DecomNet:
    features: int = 32
    compute_dtype: jnp.dtype = jnp.float32

    def init(self, key: jax.Array) -> Params:
        return init_decom_net(key, self.features)

    def apply(self, params: Params, x: jnp.ndarray):
        return apply_decom_net(params, x, self.compute_dtype)
