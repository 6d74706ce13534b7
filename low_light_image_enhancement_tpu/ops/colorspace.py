"""Color-space conversions and u8 normalization (planar layout).

All functions take planar RGB ``(..., 3, H, W)`` float32 in [0, 1] unless
stated otherwise (the planar layout of the whole pipeline).

Spec: BASELINE.json north_star ("RGB->float normalization, color-space
conversion"). HVI follows the construction of "HVI: A New Color Space for
Low-light Image Enhancement" (PAPERS.md:9) — intensity-collapsed polar chroma
plane — in a simplified, exactly-invertible form.
"""

from __future__ import annotations

import jax.numpy as jnp

_U8_SCALE = 1.0 / 255.0


def normalize_u8(x_u8: jnp.ndarray) -> jnp.ndarray:
    """uint8 [0,255] -> float32 [0,1]."""
    return x_u8.astype(jnp.float32) * _U8_SCALE


def quantize_u8(x: jnp.ndarray) -> jnp.ndarray:
    """float [0,1] -> uint8 with round-half-to-even (banker's rounding):
    jnp.round == np.rint semantics, so .5 ties go to the even integer."""
    return jnp.clip(jnp.round(x * 255.0), 0.0, 255.0).astype(jnp.uint8)


# --------------------------------------------------------------------------- #
# HSV
# --------------------------------------------------------------------------- #

def rgb_to_hsv(rgb: jnp.ndarray) -> jnp.ndarray:
    """Planar RGB -> planar HSV, h in [0,1)."""
    r, g, b = rgb[..., 0, :, :], rgb[..., 1, :, :], rgb[..., 2, :, :]
    v = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    c = v - mn
    safe_c = jnp.where(c == 0, 1.0, c)
    # Hue sector selection without data-dependent control flow.
    hr = jnp.mod((g - b) / safe_c, 6.0)
    hg = (b - r) / safe_c + 2.0
    hb = (r - g) / safe_c + 4.0
    h = jnp.where(v == r, hr, jnp.where(v == g, hg, hb))
    h = jnp.where(c == 0, 0.0, h / 6.0)
    s = jnp.where(v == 0, 0.0, c / jnp.where(v == 0, 1.0, v))
    return jnp.stack([h, s, v], axis=-3)


def hsv_to_rgb(hsv: jnp.ndarray) -> jnp.ndarray:
    """Planar HSV -> planar RGB."""
    h, s, v = hsv[..., 0, :, :], hsv[..., 1, :, :], hsv[..., 2, :, :]
    h6 = h * 6.0
    c = v * s
    x = c * (1.0 - jnp.abs(jnp.mod(h6, 2.0) - 1.0))
    m = v - c
    zeros = jnp.zeros_like(c)
    sector = jnp.floor(h6).astype(jnp.int32) % 6
    r = jnp.select(
        [sector == 0, sector == 1, sector == 2, sector == 3, sector == 4],
        [c, x, zeros, zeros, x], default=c)
    g = jnp.select(
        [sector == 0, sector == 1, sector == 2, sector == 3, sector == 4],
        [x, c, c, x, zeros], default=zeros)
    b = jnp.select(
        [sector == 0, sector == 1, sector == 2, sector == 3, sector == 4],
        [zeros, zeros, x, c, c], default=x)
    return jnp.stack([r + m, g + m, b + m], axis=-3)


# --------------------------------------------------------------------------- #
# YCbCr (BT.601 full-range)
# --------------------------------------------------------------------------- #

def rgb_to_ycbcr(rgb: jnp.ndarray) -> jnp.ndarray:
    r, g, b = rgb[..., 0, :, :], rgb[..., 1, :, :], rgb[..., 2, :, :]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 0.5 + (b - y) * (0.5 / (1.0 - 0.114))
    cr = 0.5 + (r - y) * (0.5 / (1.0 - 0.299))
    return jnp.stack([y, cb, cr], axis=-3)


def ycbcr_to_rgb(ycc: jnp.ndarray) -> jnp.ndarray:
    y, cb, cr = ycc[..., 0, :, :], ycc[..., 1, :, :], ycc[..., 2, :, :]
    r = y + (cr - 0.5) * ((1.0 - 0.299) / 0.5)
    b = y + (cb - 0.5) * ((1.0 - 0.114) / 0.5)
    g = (y - 0.299 * r - 0.114 * b) / 0.587
    return jnp.stack([r, g, b], axis=-3)


# --------------------------------------------------------------------------- #
# HVI (intensity-collapsed polar chroma; PAPERS.md:9, simplified/invertible)
# --------------------------------------------------------------------------- #

_HVI_EPS = 1e-8
_TWO_PI = 2.0 * jnp.pi


def rgb_to_hvi(rgb: jnp.ndarray) -> jnp.ndarray:
    """RGB -> (H, V, I): I = max(RGB); (H, V) = k*s*(cos, sin)(2*pi*hue)
    with collapse factor k = sin(pi*I/2) + eps, shrinking the chroma plane in
    dark regions so enhancement networks see a smoother manifold."""
    hsv = rgb_to_hsv(rgb)
    h, s, i = hsv[..., 0, :, :], hsv[..., 1, :, :], hsv[..., 2, :, :]
    k = jnp.sin(jnp.pi * i * 0.5) + _HVI_EPS
    hh = k * s * jnp.cos(_TWO_PI * h)
    vv = k * s * jnp.sin(_TWO_PI * h)
    return jnp.stack([hh, vv, i], axis=-3)


def hvi_to_rgb(hvi: jnp.ndarray) -> jnp.ndarray:
    hh, vv, i = hvi[..., 0, :, :], hvi[..., 1, :, :], hvi[..., 2, :, :]
    k = jnp.sin(jnp.pi * i * 0.5) + _HVI_EPS
    s = jnp.sqrt(hh * hh + vv * vv) / k
    s = jnp.clip(s, 0.0, 1.0)
    h = jnp.mod(jnp.arctan2(vv, hh) / _TWO_PI, 1.0)
    return hsv_to_rgb(jnp.stack([h, s, i], axis=-3))
