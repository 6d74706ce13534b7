"""Hand-written GPU kernels (Pallas, Triton route).

Each kernel reproduces the corresponding ``core``/``ops`` math tap for tap
(same coefficients, same accumulation order); the plain ``jax.numpy`` graph
stays the reference and the path for everything a kernel does not cover.
"""

from low_light_image_enhancement_tpu.kernels.fused_enhance import (
    fused_retinex,
    kernel_covers,
)

__all__ = ["fused_retinex", "kernel_covers"]
