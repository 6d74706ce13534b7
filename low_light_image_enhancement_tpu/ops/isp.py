"""Minimal RAW->sRGB ISP ops (fully-convolutional ISP family, cf. "Deep
Camera: A Fully Convolutional Network for Image Signal Processing",
PAPERS.md:6): bilinear RGGB demosaic, white balance, color-correction
matrix, and a composed ``raw_to_srgb`` that feeds the enhancement pipeline
from RAW sensor data.

All ops are pure jnp on planar/plane layouts and jit/vmap-friendly. The
demosaic is expressed as roll-based neighbor averaging (edge rows/cols use
wrap neighbors — callers pad-and-crop for exact borders, as the pipeline
does for its other windowed ops).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from low_light_image_enhancement_tpu.ops.filters import roll2d


def demosaic_bilinear_rggb(raw: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) RGGB Bayer mosaic (f32 [0,1], H and W even) ->
    (..., 3, H, W) RGB via bilinear interpolation.

    Pattern (top-left 2x2): R G / G B.
    """
    h, w = raw.shape[-2], raw.shape[-1]
    ys = jnp.arange(h).reshape(-1, 1)
    xs = jnp.arange(w).reshape(1, -1)
    r_mask = ((ys % 2 == 0) & (xs % 2 == 0)).astype(raw.dtype)
    b_mask = ((ys % 2 == 1) & (xs % 2 == 1)).astype(raw.dtype)
    g_mask = 1.0 - r_mask - b_mask

    def interp(masked, mask):
        # normalized 3x3 neighborhood average of known samples
        acc = jnp.zeros_like(masked)
        wacc = jnp.zeros_like(masked)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                wgt = 1.0 if (dy, dx) == (0, 0) else (
                    0.5 if dy == 0 or dx == 0 else 0.25
                )
                acc = acc + wgt * roll2d(masked, dy, dx)
                wacc = wacc + wgt * roll2d(mask, dy, dx)
        return acc / jnp.maximum(wacc, 1e-8)

    r = interp(raw * r_mask, r_mask)
    g = interp(raw * g_mask, g_mask)
    b = interp(raw * b_mask, b_mask)
    return jnp.stack([r, g, b], axis=-3)


def white_balance(rgb: jnp.ndarray, gains) -> jnp.ndarray:
    """Per-channel gains (3,) applied to planar RGB (..., 3, H, W)."""
    gains = jnp.asarray(gains, rgb.dtype).reshape(3, 1, 1)
    return jnp.clip(rgb * gains, 0.0, 1.0)


def gray_world_gains(rgb: jnp.ndarray) -> jnp.ndarray:
    """Auto white balance: gains that equalize channel means to the green
    channel's mean (gray-world assumption). Returns (..., 3)."""
    means = jnp.mean(rgb, axis=(-2, -1))
    g = means[..., 1:2]
    return g / jnp.maximum(means, 1e-6)


def color_correction(rgb: jnp.ndarray, ccm) -> jnp.ndarray:
    """3x3 color-correction matrix on planar RGB: out_c = sum_k M[c,k]*in_k."""
    ccm = jnp.asarray(ccm, rgb.dtype)
    out = jnp.einsum("ck,...khw->...chw", ccm, rgb,
                     precision=jax.lax.Precision.HIGHEST)  # no TF32
    return jnp.clip(out, 0.0, 1.0)


# A mild default CCM (identity with slight cross-channel correction).
DEFAULT_CCM = (
    (1.06, -0.03, -0.03),
    (-0.03, 1.06, -0.03),
    (-0.03, -0.03, 1.06),
)


def raw_to_srgb(
    raw: jnp.ndarray,
    wb_gains=None,
    ccm=DEFAULT_CCM,
    gamma: float = 1.0 / 2.2,
) -> jnp.ndarray:
    """RGGB RAW (..., H, W) f32 -> display RGB (..., 3, H, W): demosaic ->
    white balance (gray-world when gains omitted) -> CCM -> display gamma.
    Feed the result to ``EnhancePipeline`` (planar f32) for low-light
    enhancement of RAW captures."""
    rgb = demosaic_bilinear_rggb(raw)
    gains = gray_world_gains(rgb) if wb_gains is None else jnp.asarray(wb_gains)
    if gains.ndim > 1:  # batched gray-world gains
        gains = gains.reshape(gains.shape[:-1] + (3, 1, 1))
        rgb = jnp.clip(rgb * gains, 0.0, 1.0)
    else:
        rgb = white_balance(rgb, gains)
    rgb = color_correction(rgb, ccm)
    return jnp.clip(rgb, 0.0, 1.0) ** gamma
