"""Context-aggregation FCN enhancer (fast-FCN image operator family,
PAPERS.md:8: "Fast Image Processing with Fully-Convolutional Networks").

A stack of 3x3 convs with exponentially growing dilation (1,2,4,...,1) gives
a large receptive field at constant cost — the standard architecture for
approximating whole-image operators with a tiny FCN. Trained supervised on
(low, high) pairs (``train.train_fcn``), it is the paired-data counterpart to
the zero-reference curve CNN. Functional init/apply, NHWC convs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from low_light_image_enhancement_tpu.models.layers import conv2d, precision_for

Params = Dict[str, Dict[str, jnp.ndarray]]


def _dilations(depth: int) -> Tuple[int, ...]:
    # 1, 2, 4, ... capped growth, then a closing dilation-1 layer.
    ds = [min(2 ** i, 32) for i in range(depth - 1)]
    return tuple(ds) + (1,)


def init_fcn(key: jax.Array, features: int = 24, depth: int = 7) -> Params:
    dils = _dilations(depth)
    sizes = [(3, features)] + [(features, features)] * (depth - 1)
    params: Params = {}
    keys = jax.random.split(key, depth + 1)
    for i, ((cin, cout), k) in enumerate(zip(sizes, keys[:-1]), start=1):
        fan_in = 3 * 3 * cin
        w = jax.random.normal(k, (3, 3, cin, cout), jnp.float32)
        params[f"c{i}"] = {
            "w": w * jnp.sqrt(2.0 / fan_in),
            "b": jnp.zeros((cout,), jnp.float32),
        }
    wout = jax.random.normal(keys[-1], (1, 1, features, 3), jnp.float32)
    params["out"] = {
        "w": wout * jnp.sqrt(2.0 / features),
        "b": jnp.zeros((3,), jnp.float32),
    }
    return params


def apply_fcn(
    params: Params,
    x: jnp.ndarray,
    compute_dtype: jnp.dtype = jnp.float32,
) -> jnp.ndarray:
    """(..., 3, H, W) in [0,1] -> enhanced (..., 3, H, W) in [0,1]."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    depth = sum(1 for k in params if k.startswith("c"))
    dils = _dilations(depth)
    h = jnp.transpose(x, (0, 2, 3, 1))
    for i, dil in enumerate(dils, start=1):
        p = params[f"c{i}"]
        h = jax.nn.leaky_relu(conv2d(h, p["w"], p["b"], compute_dtype, dilation=dil),
                              negative_slope=0.2)
    out = jax.nn.sigmoid(
        conv2d(h, params["out"]["w"], params["out"]["b"], compute_dtype)
    ).astype(jnp.float32)
    out = jnp.transpose(out, (0, 3, 1, 2))
    return out if batched else out[0]


def apply_fcn_gemm(
    params: Params,
    x: jnp.ndarray,
    compute_dtype: jnp.dtype = jnp.float32,
) -> jnp.ndarray:
    """im2col-GEMM variant of :func:`apply_fcn` (same signature, same math to
    f32 rounding). Every 3x3 layer — dilated or not — runs as three
    accumulated (M, 3*Cin) @ (3*Cin, Cout) GEMMs (K = 216 at 24 features;
    the dilated layers' even dilations preserve pixel phase, so the packed
    patch-GEMM form can't apply — see ops/patch_conv.py). An explicit
    ``conv_impl="gemm"`` choice; XLA materializes the im2col slabs in
    device memory."""
    from low_light_image_enhancement_tpu.ops.patch_conv import (
        conv2d_im2col_gemm,
        pack_im2col_weights,
    )

    batched = x.ndim == 4
    if not batched:
        x = x[None]
    depth = sum(1 for k in params if k.startswith("c"))
    dils = _dilations(depth)
    h = jnp.transpose(x, (0, 2, 3, 1)).astype(compute_dtype)
    for i, dil in enumerate(dils, start=1):
        p = params[f"c{i}"]
        h = jax.nn.leaky_relu(
            conv2d_im2col_gemm(
                h, pack_im2col_weights(p["w"]), p["b"], compute_dtype,
                dilation=dil,
            ),
            negative_slope=0.2,
        )
    # 1x1 head: a plain channel matmul
    po = params["out"]
    out = jax.nn.sigmoid(
        jnp.einsum(
            "bhwc,cn->bhwn",
            h,
            po["w"][0, 0].astype(compute_dtype),
            preferred_element_type=jnp.float32,
            precision=precision_for(compute_dtype),
        )
        + po["b"].astype(jnp.float32)
    ).astype(jnp.float32)
    out = jnp.transpose(out, (0, 3, 1, 2))
    return out if batched else out[0]


def apply_fcn_packed(
    params: Params,
    x: jnp.ndarray,
    compute_dtype: jnp.dtype = jnp.bfloat16,
    block: tuple = (2, 2),
) -> jnp.ndarray:
    """Space-to-depth block-conv variant of :func:`apply_fcn`: the dilated
    24-channel stack runs as plain XLA convs on packed activations (96
    lanes vs 24 — ops.patch_conv.pack_block_conv_weights; even dilation d
    becomes packed rhs_dilation d/block with phase-preserving weights).
    ``block=(1, 2)`` is the half-packing (48 lanes, 2x structural FLOPs)
    for the mid-batch regime. Pure XLA, differentiable."""
    from low_light_image_enhancement_tpu.models.layers import conv2d
    from low_light_image_enhancement_tpu.ops.patch_conv import (
        conv2d_block_xla,
        depth_to_space,
        pack_block_conv_weights,
        space_to_depth,
    )

    bh, bw = block
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    depth = sum(1 for k in params if k.startswith("c"))
    dils = _dilations(depth)
    p1 = params["c1"]
    nhwc = jnp.transpose(x, (0, 2, 3, 1))
    h = jax.nn.leaky_relu(
        conv2d(nhwc, p1["w"], p1["b"], compute_dtype, dilation=dils[0]),
        negative_slope=0.2,
    )
    h = space_to_depth(h, block)
    for i, dil in enumerate(dils[1:], start=2):
        p = params[f"c{i}"]
        h = jax.nn.leaky_relu(
            conv2d_block_xla(
                h, pack_block_conv_weights(p["w"], dilation=dil,
                                           block=block), p["b"],
                compute_dtype,
                step=(max(1, dil // bh), max(1, dil // bw)),
            ),
            negative_slope=0.2,
        )
    po = params["out"]
    hn = depth_to_space(h, block)
    out = jax.nn.sigmoid(
        jnp.einsum(
            "bhwc,cn->bhwn",
            hn,
            po["w"][0, 0].astype(compute_dtype),
            preferred_element_type=jnp.float32,
            precision=precision_for(compute_dtype),
        )
        + po["b"].astype(jnp.float32)
    ).astype(jnp.float32)
    out = jnp.transpose(out, (0, 3, 1, 2))
    return out if batched else out[0]


@dataclasses.dataclass(frozen=True)
class EnhanceFCN:
    features: int = 24
    depth: int = 7
    compute_dtype: jnp.dtype = jnp.float32

    def init(self, key: jax.Array) -> Params:
        return init_fcn(key, self.features, self.depth)

    def apply(self, params: Params, x: jnp.ndarray) -> jnp.ndarray:
        return apply_fcn(params, x, self.compute_dtype)
