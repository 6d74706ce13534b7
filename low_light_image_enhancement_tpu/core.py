"""The enhancement device graph on pre-padded planar images.

This is the *reference implementation of record* (pure jnp): the fused
kernel in ``kernels/`` reproduces this math tap-for-tap, and the parity tests
compare against these functions. Everything operates on images pre-padded by
``MARGIN`` with edge replication (see ``pipeline.pad_planar``), using
wrap-around (roll) shifts — interior results are identical to edge-clamped
filtering of the unpadded image, and the corrupted outer ring (< MARGIN) is
cropped by the caller.

Boundary convention: the canvas is replicate-padded ONCE from the raw input;
cascaded windowed stages (blur -> denoise) then filter across that padding.
This differs in the outermost output pixel ring from running each stage with
its own edge clamp — both are valid conventions; this one is canonical here
because a fused kernel gets it from clamped loads of the input alone.

Spec: BASELINE.json north_star (normalization -> illumination estimation ->
reflectance/gamma boost -> curve CNN -> fused denoise + gamma).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from low_light_image_enhancement_tpu.config import MARGIN, PipelineConfig
from low_light_image_enhancement_tpu.ops.curves import apply_curves
from low_light_image_enhancement_tpu.ops.denoise import denoise_planar
from low_light_image_enhancement_tpu.ops.filters import (
    roll2d,
    separable_blur,
)

__all__ = ["MARGIN", "illumination_boost", "enhance_core_padded"]


def illumination_boost(xp: jnp.ndarray, cfg: PipelineConfig) -> jnp.ndarray:
    """Retinex stage: x * clip(blur(maxRGB), eps, 1) ** (gamma - 1)."""
    l0 = jnp.max(xp, axis=-3)
    l = separable_blur(l0, cfg.blur_radius, cfg.blur_sigma, roll2d)
    l = jnp.clip(l, cfg.illum_eps, 1.0)
    boost = jnp.exp((cfg.gamma - 1.0) * jnp.log(l))
    return jnp.clip(xp * boost[..., None, :, :], 0.0, 1.0)


def enhance_core_padded(
    xp: jnp.ndarray,
    cfg: PipelineConfig,
    curve_maps: Optional[jnp.ndarray] = None,
    do_denoise: bool = True,
) -> jnp.ndarray:
    """Full enhance graph on a padded planar image ``(..., 3, Hp, Wp)``.

    ``curve_maps`` (``(..., n_iter, 3, Hp, Wp)``) must be given for the
    "curve"/"hybrid" methods; they come from ``models.apply_curve_cnn`` on the
    same padded canvas.
    """
    x = xp
    if cfg.method in ("retinex", "hybrid"):
        x = illumination_boost(x, cfg)
    if cfg.method in ("curve", "hybrid"):
        if curve_maps is None:
            raise ValueError(f"method={cfg.method!r} requires curve_maps")
        x = jnp.clip(apply_curves(x, curve_maps), 0.0, 1.0)
    if do_denoise and cfg.denoise_strength > 0.0:
        inv2s2 = 1.0 / (2.0 * cfg.denoise_sigma * cfg.denoise_sigma)
        x = denoise_planar(x, inv2s2, cfg.denoise_strength, roll2d,
                           cfg.denoise_kernel, cfg.denoise_guide,
                           cfg.denoise_taps, cfg.guided_radius,
                           cfg.guided_eps)
    return jnp.clip(x, 0.0, 1.0)
