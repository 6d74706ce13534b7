"""Guided filter (He et al.) — edge-aware smoothing in O(1) per pixel
regardless of radius.

Planar layout like every op here: images are ``(..., H, W)`` planes. The
box sums run on integral images (``jnp.cumsum`` + two shifted differences
per axis), so the cost is constant in ``radius`` — unlike the bilateral's
O(taps) shifted reads — making large smoothing radii free. Edge windows
are true means (normalized by a box-counted ones plane), matching
replicate-free SAME semantics.

Spec: BASELINE.json north_star "fused denoise" family; this is the
measured-alternative pattern the bilateral variants follow
(docs/PERFORMANCE.md @84fe805 "What bounds the bilateral") — kept as a public op;
the fused Pallas tail ships the bilateral.
"""

from __future__ import annotations

import jax.numpy as jnp


def box_mean(x: jnp.ndarray, radius: int) -> jnp.ndarray:
    """(..., H, W) -> windowed mean over (2r+1)^2, true means at edges.

    Integral-image form: cumsum along each axis, then one subtraction per
    axis gives the window SUM; dividing by the same operator applied to a
    ones plane yields the exact mean for truncated edge windows.
    """
    if radius < 1:
        return x
    ones = jnp.ones(x.shape[-2:], x.dtype)
    return _box_sum(x, radius) / _box_sum(ones, radius)


def _box_sum_1d(x: jnp.ndarray, r: int, axis: int) -> jnp.ndarray:
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    c = jnp.cumsum(x, axis=-1)
    # window sum at i = c[min(i + r, n-1)] - c[i - r - 1]   (c[-1] := 0)
    hi = jnp.clip(jnp.arange(n) + r, 0, n - 1)
    lo = jnp.arange(n) - r - 1
    c_hi = c[..., hi]
    c_lo = jnp.where(lo >= 0, c[..., jnp.clip(lo, 0, n - 1)], 0)
    return jnp.moveaxis(c_hi - c_lo, -1, axis)


def _box_sum(x: jnp.ndarray, r: int) -> jnp.ndarray:
    return _box_sum_1d(_box_sum_1d(x, r, -1), r, -2)


def guided_filter(
    p: jnp.ndarray,
    guide: jnp.ndarray,
    radius: int = 2,
    eps: float = 1e-3,
) -> jnp.ndarray:
    """Filter plane(s) ``p`` (..., H, W) with a shared single-plane
    ``guide`` (broadcastable to p): output is locally a linear transform
    of the guide, so edges present in the guide survive while everything
    else smooths. ``eps`` is the edge/flat threshold in guide-variance
    units (larger -> closer to a plain box blur). Differentiable.
    """
    m_i = box_mean(guide, radius)
    m_p = box_mean(p, radius)
    cov = box_mean(guide * p, radius) - m_i * m_p
    var = box_mean(guide * guide, radius) - m_i * m_i
    a = cov / (var + eps)
    b = m_p - a * m_i
    return box_mean(a, radius) * guide + box_mean(b, radius)


def guided_denoise(
    x: jnp.ndarray,
    radius: int = 2,
    eps: float = 1e-3,
    strength: float = 1.0,
) -> jnp.ndarray:
    """(..., 3, H, W) RGB denoise: every channel guided by the luminance
    plane (the same luma-joint trick the default bilateral uses —
    chroma smoothing follows luminance edges, no per-channel fringing),
    blended by ``strength`` like ops.denoise.bilateral_denoise."""
    r, g, b = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    luma = 0.299 * r + 0.587 * g + 0.114 * b
    q = guided_filter(x, luma[..., None, :, :], radius, eps)
    return x + strength * (q - x)


# --------------------------------------------------------------------- #
# Shift-based cores (the padded-canvas form)
# --------------------------------------------------------------------- #
# The cumsum integral-image form above is the O(1)-in-radius public op with
# true edge means. The pipeline instead runs on a replicate-padded canvas
# where every consumed pixel's window is fully populated — there the box
# mean is a plain separable (2r+1)-tap average expressed through the SAME
# ``shift_fn`` convention as the bilateral cores (``jnp.roll`` on the
# canvas). The canvas margin must cover the cascade's receptive radius 2r
# (``config.canvas_margin``).


def box_mean_shift(x: jnp.ndarray, radius: int, shift_fn) -> jnp.ndarray:
    """(2r+1)^2 separable box mean over the last two axes via shifts."""
    k = 1.0 / (2 * radius + 1)
    for dy, dx in ((1, 0), (0, 1)):
        acc = x
        for t in range(1, radius + 1):
            acc = acc + shift_fn(x, t * dy, t * dx) \
                + shift_fn(x, -t * dy, -t * dx)
        x = acc * k
    return x


def guided_core_shift(x, eps, strength, shift_fn, radius: int = 2):
    """Self-guided filter of one plane (guide = the plane itself) in the
    shift convention; the per-channel analogue of ``bilateral_core``."""
    m = box_mean_shift(x, radius, shift_fn)
    var = box_mean_shift(x * x, radius, shift_fn) - m * m
    a = var / (var + eps)
    b = m - a * m
    q = box_mean_shift(a, radius, shift_fn) * x \
        + box_mean_shift(b, radius, shift_fn)
    return x + strength * (q - x)


def guided_joint_core_shift(planes, eps, strength, shift_fn,
                            radius: int = 2):
    """Luma-guided filter of the 3 channel planes in the shift convention;
    the joint analogue of ``bilateral_joint_core`` (same channel-mean luma
    guide as the joint bilateral)."""
    g = (planes[0] + planes[1] + planes[2]) * (1.0 / 3.0)
    m_g = box_mean_shift(g, radius, shift_fn)
    var = box_mean_shift(g * g, radius, shift_fn) - m_g * m_g
    inv = 1.0 / (var + eps)
    out = []
    for p in planes:
        m_p = box_mean_shift(p, radius, shift_fn)
        cov = box_mean_shift(g * p, radius, shift_fn) - m_g * m_p
        a = cov * inv
        b = m_p - a * m_g
        q = box_mean_shift(a, radius, shift_fn) * g \
            + box_mean_shift(b, radius, shift_fn)
        out.append(p + strength * (q - p))
    return out
