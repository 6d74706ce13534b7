"""Low-light image enhancement framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capability surface of
CILAB-IITM/Low_Light_Image_Enhancement (reference repo is documentation-only:
/root/reference/README.md:1-2; the functional spec is BASELINE.json's
``north_star``): host-side JPEG/PNG decode feeding a fused device graph that
performs RGB->float normalization, color-space conversion, Retinex-style
illumination estimation + reflectance division, an optional Zero-DCE-style
curve-adjustment CNN, and fused denoise + gamma correction — batched, jitted,
with a fused Pallas kernel on the GPU, and shardable over a device mesh.

Public API::

    import low_light_image_enhancement_tpu as llie
    out = llie.enhance(img_u8_hwc)              # single image, u8 HWC -> u8 HWC
    outs = llie.enhance_batch(imgs_u8_bhwc)     # batched
    pipe = llie.EnhancePipeline(llie.PipelineConfig(gamma=0.5))
"""

from low_light_image_enhancement_tpu.config import PipelineConfig, PRESETS
from low_light_image_enhancement_tpu.pipeline import (
    EnhancePipeline,
    enhance,
    enhance_batch,
)

__version__ = "0.1.0"

__all__ = [
    "PipelineConfig",
    "PRESETS",
    "EnhancePipeline",
    "enhance",
    "enhance_batch",
    "__version__",
]
