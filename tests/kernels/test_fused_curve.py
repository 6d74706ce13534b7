"""The curve/hybrid tail (plain jnp: upsampled curve maps -> LE-curve
iterations -> denoise -> quantize) against an independent in-test
reference built on the same halo'd block — the kernel-vs-reference
mechanism of SURVEY.md §4 applied to the path that replaced the fused
curve kernel."""

import jax.numpy as jnp
import numpy as np
import pytest

from low_light_image_enhancement_tpu.blocks import (
    _curve_maps,
    _mask_extent,
    block_geometry,
    enhance_learned_block,
    replicate_margin_cols,
    resolve_conv_impl,
    single_block_halo,
)
from low_light_image_enhancement_tpu.config import PipelineConfig, canvas_margin
from low_light_image_enhancement_tpu.data.synth import synth_batch
from low_light_image_enhancement_tpu.ops.colorspace import (
    normalize_u8,
    quantize_u8,
)
from low_light_image_enhancement_tpu.ops.denoise import denoise_planar
from low_light_image_enhancement_tpu.ops.filters import roll2d, separable_blur
from low_light_image_enhancement_tpu.pipeline import EnhancePipeline


def _block(x, cfg, halo):
    """(B, 3, H, W) -> the edge-padded block the pipeline builds."""
    h, w = x.shape[-2:]
    h_core, wp = block_geometry(cfg, h, w)
    m = canvas_margin(cfg)
    return jnp.pad(x, ((0, 0), (0, 0), (halo, halo + h_core - h),
                       (m, wp - w - m)), mode="edge")


def _tail_reference(xb, cfg, params, h, w, halo):
    """The curve/hybrid algebra written out on an f32 block: (hybrid) boost
    x * clip(blur(maxRGB), eps, 1)**(gamma-1) with replicated margin
    columns, maps from the masked block, n_iter LE iterations, clip,
    bilateral, clip, crop."""
    cfg = resolve_conv_impl(cfg)
    m = canvas_margin(cfg)
    y = xb
    if cfg.method == "hybrid":
        l = separable_blur(jnp.max(y, axis=-3), cfg.blur_radius,
                           cfg.blur_sigma, roll2d)
        boost = jnp.exp((cfg.gamma - 1.0)
                        * jnp.log(jnp.clip(l, cfg.illum_eps, 1.0)))
        y = replicate_margin_cols(jnp.clip(y * boost[:, None], 0.0, 1.0),
                                  w, m)
    maps = _curve_maps(_mask_extent(y, -halo, h, w, m), cfg, params)
    for i in range(cfg.curve_iters):
        a = maps[:, i]
        y = y + a * y * (1.0 - y)
    y = jnp.clip(y, 0.0, 1.0)
    if cfg.denoise_strength > 0.0:
        inv2s2 = 1.0 / (2.0 * cfg.denoise_sigma ** 2)
        y = denoise_planar(y, inv2s2, cfg.denoise_strength, roll2d,
                           cfg.denoise_kernel, cfg.denoise_guide,
                           cfg.denoise_taps)
    return jnp.clip(y, 0.0, 1.0)[..., halo : halo + h, m : m + w]


def _reference_u8(lows, cfg, params):
    h, w = lows.shape[1:3]
    halo = single_block_halo(cfg)
    x = normalize_u8(jnp.asarray(np.moveaxis(lows, -1, 1)))
    y = _tail_reference(_block(x, cfg, halo), cfg, params, h, w, halo)
    return np.moveaxis(np.asarray(quantize_u8(y)), 1, -1)


def _assert_ties(got, want):
    # The reference's op order differs from the block's in places (the
    # boost chain, the curve update's FMA contraction), so isolated u8
    # rounding ties may flip: <= 1 step on < 0.1% of pixels.
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("method", ["curve", "hybrid"])
@pytest.mark.parametrize("size", [(64, 96), (33, 47), (96, 200)])
def test_fused_curve_pipeline_parity_u8(method, size):
    h, w = size
    lows, _ = synth_batch(2, h, w)
    cfg = PipelineConfig(method=method, compute_dtype="float32")
    pipe = EnhancePipeline(cfg)
    _assert_ties(pipe.enhance_batch(lows),
                 _reference_u8(lows, cfg, pipe.model_params))


def test_fused_curve_no_denoise_and_downsample():
    lows, _ = synth_batch(1, 48, 80)
    for cfg in (
        PipelineConfig(method="curve", denoise_strength=0.0),
        PipelineConfig(method="curve", curve_downsample=2),
        PipelineConfig(method="curve", curve_downsample=4),
        PipelineConfig(method="hybrid", curve_downsample=4),
    ):
        cfg = cfg.replace(compute_dtype="float32")
        pipe = EnhancePipeline(cfg)
        _assert_ties(pipe.enhance_batch(lows),
                     _reference_u8(lows, cfg, pipe.model_params))


def test_fused_curve_f32_blocks():
    """f32 block in -> f32 out (the sharded-path dtype)."""
    from low_light_image_enhancement_tpu.blocks import learned_halo

    cfg = PipelineConfig(method="curve", compute_dtype="float32")
    pipe = EnhancePipeline(cfg)
    rng = np.random.default_rng(0)
    h, w = 40, 56
    halo = learned_halo(cfg)
    xb = _block(jnp.asarray(rng.random((1, 3, h, w), np.float32)), cfg, halo)
    got = enhance_learned_block(xb, cfg, pipe.model_params, row0=-halo,
                                h=h, w=w)
    m = canvas_margin(cfg)
    want = _tail_reference(xb, cfg, pipe.model_params, h, w, halo)
    assert got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got)[..., m : m + w],
                               np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("impl", ["packed", "packed12"])
def test_fused_tail_with_packed_cnn_impls(impl):
    """The block-conv CNN impls compose with the tail. f32 conv compute
    pins the comparison (under the bf16 default the packing's contraction
    reorder flips ~20% of pixels by 1 u8 step, fine visually but not a
    parity statement); remaining divergence is isolated u8 rounding
    ties."""
    lows, _ = synth_batch(2, 48, 80)
    cfg = PipelineConfig(method="curve", conv_impl=impl,
                         compute_dtype="float32")
    ref = EnhancePipeline(cfg.replace(conv_impl="xla"))
    packed = EnhancePipeline(cfg, model_params=ref.model_params)
    _assert_ties(packed.enhance_batch(lows), ref.enhance_batch(lows))
