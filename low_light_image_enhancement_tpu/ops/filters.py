"""Windowed-filter building blocks shared by the jnp path and Pallas kernels.

Everything here is expressed as sums of 2-D shifts so that the fused kernel
(``..kernels.fused_enhance``) can reproduce the math from offset loads: same
taps, same accumulation order, same coefficients. That shared structure is
what keeps the kernel-vs-jnp parity tests exact up to u8 rounding ties.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import jax.numpy as jnp


@lru_cache(maxsize=None)
def gaussian_kernel_1d(radius: int, sigma: float) -> Tuple[float, ...]:
    """Normalized 1-D Gaussian taps as Python floats (trace-time constants)."""
    xs = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-radius, radius + 1)]
    total = sum(xs)
    return tuple(x / total for x in xs)


def roll2d(x: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Circular shift over the last two axes: out[y, x] = in[y-dy, x-dx].

    Wrap-around semantics — callers must pre-pad by the filter margin and
    crop.
    """
    if dy:
        x = jnp.roll(x, dy, axis=-2)
    if dx:
        x = jnp.roll(x, dx, axis=-1)
    return x


def _shift1d_clamp(x: jnp.ndarray, d: int, axis: int) -> jnp.ndarray:
    n = x.shape[axis]
    out = jnp.roll(x, d, axis=axis)
    idx = jnp.arange(n).reshape((-1,) + (1,) * (x.ndim - 1 - (axis % x.ndim)))
    if d > 0:
        edge = jnp.take(x, jnp.array([0]), axis=axis)
        out = jnp.where(idx < d, edge, out)
    elif d < 0:
        edge = jnp.take(x, jnp.array([n - 1]), axis=axis)
        out = jnp.where(idx >= n + d, edge, out)
    return out


def shift2d(x: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Edge-replicating shift over the last two axes (public-op semantics):
    out[y, x] = in[clamp(y - dy), clamp(x - dx)]."""
    if dy:
        x = _shift1d_clamp(x, dy, x.ndim - 2)
    if dx:
        x = _shift1d_clamp(x, dx, x.ndim - 1)
    return x


def upsample_int(x, ds: int, axis: int, shift_fn):
    """Integer-factor bilinear upsample along ``axis`` (half-pixel grid —
    numerically ~1 ulp from ``jax.image.resize(method='bilinear')``, and THE
    upsample of record for curve maps): repeat + two shifts + per-phase
    blend. ``ds`` must be even (or 1).

    out[i] = (1-f)*rep[i - ds/2] + f*rep[i + ds/2], rep[i] = x[i // ds],
    f depending only on i mod ds — which is what makes shard-local and
    stripe-local evaluation coincide with the global one on interiors.
    """
    if ds == 1:
        return x
    if ds % 2:
        raise ValueError(f"upsample_int needs an even factor, got {ds}")
    import jax

    ax = axis % x.ndim
    rep = jnp.repeat(x, ds, axis=ax)
    half = ds // 2
    dy, dx = (half, 0) if ax == rep.ndim - 2 else (0, half)
    lo = shift_fn(rep, dy, dx)      # rep[i - half]
    hi = shift_fn(rep, -dy, -dx)    # rep[i + half]
    f = upsample_phase(rep.shape[-2:], ds, ax - (x.ndim - 2), x.dtype)
    return lo * (1.0 - f) + hi * f


@lru_cache(maxsize=None)
def _phase_consts(ds: int) -> Tuple[float, ...]:
    return tuple(float((((p + 0.5) / ds) - 0.5) % 1.0) for p in range(ds))


def upsample_phase(shape2d, ds: int, axis2d: int, dtype) -> jnp.ndarray:
    """The (H, W) blend-weight plane of ``upsample_int``: f depending only
    on the index mod ds along ``axis2d`` (0=rows, 1=cols). Exposed so
    kernels applying many channels can compute it once and reuse it."""
    import jax

    phase = jax.lax.broadcasted_iota(jnp.int32, tuple(shape2d),
                                     len(shape2d) - 2 + axis2d) % ds
    consts = _phase_consts(ds)
    f = jnp.full(tuple(shape2d), consts[0], dtype)
    for p in range(1, ds):
        f = jnp.where(phase == p, jnp.asarray(consts[p], dtype), f)
    return f


def separable_blur(x, radius, sigma, shift_fn):
    """Separable Gaussian blur as two tap loops over ``shift_fn``.

    This is THE blur of the framework: every consumer (jnp core, SSIM
    window, video path) calls it with its own shift function
    so taps and accumulation order — and therefore kernel-vs-jnp parity —
    stay identical everywhere by construction.
    """
    taps = gaussian_kernel_1d(radius, sigma)
    acc = None
    for i, t in enumerate(taps):
        term = t * shift_fn(x, i - radius, 0)
        acc = term if acc is None else acc + term
    out = None
    for j, t in enumerate(taps):
        term = t * shift_fn(acc, 0, j - radius)
        out = term if out is None else out + term
    return out


def gaussian_blur(
    x: jnp.ndarray, radius: int = 2, sigma: float = 1.0, mode: str = "clamp"
) -> jnp.ndarray:
    """Separable Gaussian blur over the last two axes.

    mode="clamp": edge-replicate boundary (public-op semantics).
    mode="wrap":  circular boundary — for pre-padded inputs; identical to the
                  fused kernel's roll-based blur on the interior.
    """
    shift_fn = shift2d if mode == "clamp" else roll2d
    return separable_blur(x, radius, sigma, shift_fn)
