"""Fused retinex kernel (Pallas, Triton route) vs the plain jnp graph.

The kernel runs under the Pallas interpreter here. It evaluates the same
f32 ops in the same order as the plain path, so on the CPU the two agree
exactly up to u8 rounding ties: the bound is one u8 step, with at most a
few pixels at it. On the GPU the kernel's exp/log differ from XLA's in the
last ulps; chip_smoke.py checks that bound there.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from low_light_image_enhancement_tpu.config import PipelineConfig
from low_light_image_enhancement_tpu.data.synth import synth_batch
from low_light_image_enhancement_tpu.kernels.fused_enhance import (
    fused_retinex,
    kernel_covers,
)
from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

TIE_FRACTION = 1e-3  # u8 rounding ties: at most this share of pixels


def _low(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 120, (b, h, w, 3), dtype=np.uint8)


def _kernel(imgs, cfg, tile=(8, 32, 4)):
    planar = jnp.asarray(np.moveaxis(imgs, -1, 1))
    out = fused_retinex(planar, cfg, interpret=True, tile=tile)
    return np.moveaxis(np.asarray(out), 1, -1)


def _assert_close(got, want):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= TIE_FRACTION, (d > 0).mean()


@pytest.mark.parametrize("h,w", [(40, 72), (104, 200), (33, 47)])
@pytest.mark.parametrize("guide,taps", [
    ("perchannel", "full"), ("luma", "full"),
    ("perchannel", "sep"), ("luma", "sep"),
])
def test_fused_retinex_parity_interpret(h, w, guide, taps):
    cfg = PipelineConfig(denoise_guide=guide, denoise_taps=taps)
    imgs = _low(2, h, w, seed=1)
    want = EnhancePipeline(cfg, force_jnp=True).enhance_batch(imgs)
    _assert_close(_kernel(imgs, cfg), want)


@pytest.mark.parametrize("tile", [(8, 16, 4), (16, 64, 4), (4, 128, 2)])
def test_tile_shape_does_not_change_output(tile):
    """Tiles that do not divide the image: masked stores and clamped loads
    at every tile edge."""
    cfg = PipelineConfig()
    imgs = _low(1, 37, 53, seed=3)
    want = EnhancePipeline(cfg, force_jnp=True).enhance_batch(imgs)
    _assert_close(_kernel(imgs, cfg, tile=tile), want)


@pytest.mark.parametrize("over", [
    {"denoise_kernel": "epan"},
    {"denoise_strength": 0.0},
    {"blur_radius": 3, "blur_sigma": 1.5},
    {"gamma": 0.6, "denoise_strength": 0.5, "denoise_sigma": 0.1},
])
def test_covered_variants(over):
    cfg = PipelineConfig(**over)
    assert kernel_covers(cfg)
    imgs = _low(1, 24, 40, seed=4)
    want = EnhancePipeline(cfg, force_jnp=True).enhance_batch(imgs)
    _assert_close(_kernel(imgs, cfg), want)


def test_pipeline_interpret_matches_jnp_end_to_end():
    lows, _ = synth_batch(2, 40, 72)
    cfg = PipelineConfig()
    jnp_pipe = EnhancePipeline(cfg, force_jnp=True)
    pal_pipe = EnhancePipeline(cfg, pallas_interpret=True)
    assert pal_pipe._use_kernel and not jnp_pipe._use_kernel
    _assert_close(pal_pipe.enhance_batch(lows), jnp_pipe.enhance_batch(lows))


def test_rejects_uncovered_config_and_bad_input():
    with pytest.raises(ValueError, match="does not cover"):
        fused_retinex(jnp.zeros((1, 3, 8, 8), jnp.uint8),
                      PipelineConfig(denoise_taps="guided"), interpret=True)
    with pytest.raises(ValueError, match="uint8"):
        fused_retinex(jnp.zeros((1, 3, 8, 8), jnp.float32),
                      PipelineConfig(), interpret=True)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(48, 400, 600), (1, 33, 47)])
def test_compiled_kernel_matches_plain_graph(gpu_device, shape):
    """The kernel as compiled for the card (no interpreter) against XLA's
    plain graph: one u8 step at most (exp/log ulps differ between the two
    compilers), on few pixels."""
    b, h, w = shape
    imgs = _low(b, h, w, seed=9)
    cfg = PipelineConfig()
    kern = EnhancePipeline(cfg)
    assert kern._use_kernel
    _assert_close(kern.enhance_batch(imgs),
                  EnhancePipeline(cfg, force_jnp=True).enhance_batch(imgs))
