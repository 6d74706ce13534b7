"""Pure-JAX image ops (the reference implementations of record).

Layout convention: every op here works on *planar* images — ``(..., H, W)`` single planes or ``(..., 3, H, W)``
RGB — never channels-last. The pipeline transposes at the API boundary.

The fused kernel in ``..kernels`` re-implements exactly this math; kernel
parity tests compare against these functions.
"""

from low_light_image_enhancement_tpu.ops.colorspace import (
    normalize_u8,
    quantize_u8,
    rgb_to_hsv,
    hsv_to_rgb,
    rgb_to_ycbcr,
    ycbcr_to_rgb,
    rgb_to_hvi,
    hvi_to_rgb,
)
from low_light_image_enhancement_tpu.ops.filters import (
    gaussian_kernel_1d,
    shift2d,
    gaussian_blur,
)
from low_light_image_enhancement_tpu.ops.retinex import (
    illumination_map,
    reflectance,
    retinex_enhance,
)
from low_light_image_enhancement_tpu.ops.gamma import gamma_correct
from low_light_image_enhancement_tpu.ops.denoise import bilateral_denoise
from low_light_image_enhancement_tpu.ops.guided import (
    box_mean,
    guided_denoise,
    guided_filter,
)
from low_light_image_enhancement_tpu.ops.curves import apply_curves
from low_light_image_enhancement_tpu.ops.isp import (
    demosaic_bilinear_rggb,
    white_balance,
    gray_world_gains,
    color_correction,
    raw_to_srgb,
)
from low_light_image_enhancement_tpu.ops.fourier import (
    fourier_amplitude_boost,
    amplitude_phase_swap,
)
from low_light_image_enhancement_tpu.ops.contrast import (
    autocontrast,
    clahe,
    equalize_hist,
)

__all__ = [
    "normalize_u8",
    "quantize_u8",
    "rgb_to_hsv",
    "hsv_to_rgb",
    "rgb_to_ycbcr",
    "ycbcr_to_rgb",
    "rgb_to_hvi",
    "hvi_to_rgb",
    "gaussian_kernel_1d",
    "shift2d",
    "gaussian_blur",
    "illumination_map",
    "reflectance",
    "retinex_enhance",
    "gamma_correct",
    "bilateral_denoise",
    "box_mean",
    "guided_denoise",
    "guided_filter",
    "apply_curves",
    "demosaic_bilinear_rggb",
    "white_balance",
    "gray_world_gains",
    "color_correction",
    "raw_to_srgb",
    "fourier_amplitude_boost",
    "amplitude_phase_swap",
    "autocontrast",
    "clahe",
    "equalize_hist",
]
