"""Shared conv primitive for all model families.

NHWC 3x3 (optionally dilated) conv in a uniform compute dtype — uniform
dtypes keep the conv VJP well-typed on jax 0.9. A float32 compute dtype
asks for full f32 products (``precision``): left to its default, the GPU
runs f32 convolutions in TF32.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_CONV_DN = ("NHWC", "HWIO", "NHWC")


def precision_for(compute_dtype):
    """HIGHEST for float32 compute (no TF32 products), default otherwise."""
    return (lax.Precision.HIGHEST
            if jnp.dtype(compute_dtype) == jnp.float32 else None)


def conv2d(x, w, b, compute_dtype, dilation: int = 1):
    y = lax.conv_general_dilated(
        x.astype(compute_dtype),
        w.astype(compute_dtype),
        window_strides=(1, 1),
        padding="SAME",
        rhs_dilation=(dilation, dilation),
        dimension_numbers=_CONV_DN,
        precision=precision_for(compute_dtype),
    )
    return y + b.astype(compute_dtype)
