import numpy as np
import jax.numpy as jnp

import low_light_image_enhancement_tpu as llie
from low_light_image_enhancement_tpu.config import PipelineConfig
from low_light_image_enhancement_tpu.core import MARGIN, enhance_core_padded
from low_light_image_enhancement_tpu.data.synth import synth_batch, synth_pair
from low_light_image_enhancement_tpu.ops.denoise import bilateral_denoise
from low_light_image_enhancement_tpu.ops.retinex import retinex_enhance
from low_light_image_enhancement_tpu.pipeline import EnhancePipeline, pad_planar


def test_enhance_shape_dtype_and_brightening():
    low, _ = synth_pair(0, 64, 96)
    out = llie.enhance(low)
    assert out.shape == low.shape and out.dtype == np.uint8
    assert out.astype(np.float64).mean() > low.astype(np.float64).mean() * 1.5


def test_enhance_batch_matches_single():
    lows, _ = synth_batch(3, 48, 80)
    pipe = EnhancePipeline()
    batch = pipe.enhance_batch(lows)
    for i in range(3):
        single = pipe.enhance(lows[i])
        np.testing.assert_array_equal(batch[i], single)


def test_core_padded_equals_public_ops_interior():
    """Wrap-shift core on the edge-padded canvas must exactly reproduce the
    clamp-mode public ops composition away from the border. The outermost
    1-pixel ring may differ slightly: the canonical (padded-canvas) semantics
    boosts the replicated raw padding, while the clamp composition replicates
    the boosted edge — two legitimate boundary conventions for the cascaded
    windowed stages."""
    cfg = PipelineConfig()
    rng = np.random.default_rng(0)
    h, w = 40, 72
    x = jnp.asarray(rng.random((3, h, w), dtype=np.float32))
    xp = pad_planar(x, MARGIN)
    got = np.asarray(
        enhance_core_padded(xp, cfg)[..., MARGIN : MARGIN + h, MARGIN : MARGIN + w]
    )
    want_boost = retinex_enhance(
        x, gamma=cfg.gamma, eps=cfg.illum_eps,
        radius=cfg.blur_radius, sigma=cfg.blur_sigma, mode="clamp",
    )
    want = np.asarray(
        jnp.clip(
            bilateral_denoise(
                want_boost, cfg.denoise_sigma, cfg.denoise_strength,
                mode="clamp", kind=cfg.denoise_kernel,
                guide=cfg.denoise_guide, taps=cfg.denoise_taps,
            ),
            0.0, 1.0,
        )
    )
    np.testing.assert_allclose(got[..., 1:-1, 1:-1], want[..., 1:-1, 1:-1],
                               atol=1e-6)
    np.testing.assert_allclose(got, want, atol=0.05)  # border ring


def test_curve_method_runs_and_is_bounded():
    cfg = PipelineConfig(method="curve", curve_iters=4, curve_features=8)
    pipe = EnhancePipeline(cfg, rng_seed=0)
    low, _ = synth_pair(1, 40, 64)
    out = pipe.enhance(low)
    assert out.shape == low.shape and out.dtype == np.uint8


def test_curve_downsample_close_to_full_res():
    """Curve maps are smooth (TV-regularized), so estimating them at 1/4
    resolution must stay close to full-res output."""
    low, _ = synth_pair(4, 64, 96)
    full = EnhancePipeline(
        PipelineConfig(method="curve", curve_iters=4, curve_features=8)
    ).enhance(low)
    fast = EnhancePipeline(
        PipelineConfig(method="curve", curve_iters=4, curve_features=8,
                       curve_downsample=4)
    ).enhance(low)
    assert fast.shape == full.shape
    mad = np.abs(fast.astype(np.int32) - full.astype(np.int32)).mean()
    assert mad < 8.0, mad  # untrained net; trained maps are far smoother


def test_hybrid_method_runs():
    cfg = PipelineConfig(method="hybrid", curve_iters=2, curve_features=8)
    pipe = EnhancePipeline(cfg)
    low, _ = synth_pair(2, 40, 64)
    out = pipe.enhance(low)
    assert out.astype(np.float64).mean() > low.astype(np.float64).mean()


def test_jit_cache_one_entry_per_shape():
    pipe = EnhancePipeline()
    lows, _ = synth_batch(2, 32, 48)
    pipe.enhance_batch(lows)
    pipe.enhance_batch(lows)
    assert len(pipe._cache) == 1
    pipe.enhance(lows[0])
    assert len(pipe._cache) == 2


def test_float_input_rejected_with_clear_error():
    import pytest

    pipe = EnhancePipeline()
    with pytest.raises(TypeError, match="uint8"):
        pipe.enhance_batch_device(jnp.zeros((1, 16, 16, 3), jnp.float32))


def test_warmup_precompiles():
    pipe = EnhancePipeline(bucket=64)
    pipe.warmup([(1, 40, 60), (2, 100, 60)])
    assert len(pipe._cache) == 2
    lows, _ = synth_batch(1, 40, 60)
    pipe.enhance_batch(lows)  # served from cache
    assert len(pipe._cache) == 2


def test_odd_sizes_pad_correctly():
    for h, w in [(33, 47), (8, 128), (130, 200)]:
        low, _ = synth_pair(3, h, w)
        out = llie.enhance(low)
        assert out.shape == (h, w, 3)


def test_hybrid_left_edge_independent_of_right_edge_content():
    """Boundary invariant (blocks.py module docstring): the wrap-roll blur
    corrupts the MARGIN columns of the boosted canvas, and before the
    replicate_margin_cols fix the hybrid CNN (radius >= 7 > MARGIN) read
    them, so LEFT-edge output shifted with RIGHT-edge content. Two images
    identical except in their right quarter must now produce identical
    hybrid output in the left quarter."""
    cfg = PipelineConfig(method="hybrid", curve_iters=2, curve_features=8)
    pipe = EnhancePipeline(cfg, rng_seed=0, force_jnp=True)
    rng = np.random.default_rng(5)
    a = (rng.random((48, 96, 3)) * 80).astype(np.uint8)
    b = a.copy()
    b[:, 72:] = 255 - b[:, 72:]  # flip the right quarter
    out_a = pipe.enhance(a)
    out_b = pipe.enhance(b)
    np.testing.assert_array_equal(out_a[:, :24], out_b[:, :24])


def test_weights_name_config_resolves_named_weights():
    """A config carrying weights_name loads that NAMED set instead of the
    method default (presets pair measured quality numbers with the weights
    that produced them — round 5)."""
    import numpy as np

    from low_light_image_enhancement_tpu.config import PipelineConfig
    from low_light_image_enhancement_tpu.models.weights import resolve_weights
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    cfg = PipelineConfig(method="curve", weights_name="zeroref")
    pipe = EnhancePipeline(cfg, force_jnp=True)
    want = resolve_weights("zeroref")
    got = pipe.model_params
    np.testing.assert_array_equal(np.asarray(got["c1"]["w"]),
                                  np.asarray(want["c1"]["w"]))
    # explicit model_params still win over weights_name
    explicit = EnhancePipeline(cfg, model_params=want, force_jnp=True)
    assert explicit.model_params is want
