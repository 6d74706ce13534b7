import numpy as np
import pytest

from low_light_image_enhancement_tpu.config import PipelineConfig
from low_light_image_enhancement_tpu.data.synth import synth_pair
from low_light_image_enhancement_tpu.pipeline import EnhancePipeline
from low_light_image_enhancement_tpu.video import VideoEnhancer


def _flickering_video(n=8, h=40, w=64, seed=0):
    """Static scene under illumination that flickers frame to frame."""
    rng = np.random.default_rng(seed)
    _, gt = synth_pair(0, h, w, seed=seed)
    scene = gt.astype(np.float32) / 255.0
    frames = []
    for _ in range(n):
        level = 0.15 + 0.10 * rng.random()  # flicker between 0.15 and 0.25
        f = np.clip(scene * level + rng.normal(0, 0.005, scene.shape), 0, 1)
        frames.append((f * 255).astype(np.uint8))
    return frames


def test_alpha_one_matches_stateless_pipeline():
    frames = _flickering_video(3)
    ve = VideoEnhancer(PipelineConfig(), alpha=1.0)
    pipe = EnhancePipeline(PipelineConfig(), force_jnp=True)
    for f in frames:
        # same math up to one fp-associativity ulp in the exp/log chain
        d = np.abs(ve.process(f).astype(int) - pipe.enhance(f).astype(int))
        assert d.max() <= 1


def test_temporal_smoothing_reduces_flicker():
    frames = _flickering_video(10)

    def flicker(outs):
        means = np.array([o.astype(np.float64).mean() for o in outs])
        return np.abs(np.diff(means)).mean()

    ve_smooth = VideoEnhancer(PipelineConfig(), alpha=0.2)
    ve_off = VideoEnhancer(PipelineConfig(), alpha=1.0)
    smooth = [ve_smooth.process(f) for f in frames]
    raw = [ve_off.process(f) for f in frames]
    assert flicker(smooth) < flicker(raw) * 0.8


def test_constant_video_is_stable():
    frame = _flickering_video(1)[0]
    ve = VideoEnhancer(PipelineConfig(), alpha=0.3)
    outs = [ve.process(frame) for _ in range(4)]
    # EMA converges onto the same illumination -> outputs settle exactly
    np.testing.assert_array_equal(outs[-1], outs[-2])


def test_reset_and_size_guard():
    frames = _flickering_video(2)
    ve = VideoEnhancer(PipelineConfig(), alpha=0.3)
    ve.process(frames[0])
    ve.reset()
    ve.process(frames[1])
    with pytest.raises(ValueError, match="frame size changed"):
        ve.process(np.zeros((8, 8, 3), np.uint8))


@pytest.mark.parametrize("method", ["hybrid", "curve"])
def test_learned_video_alpha_one_matches_stateless(method):
    """At alpha=1 (no smoothing) the learned video paths reduce to the
    stateless pipeline (same block graph, up to fp-associativity ties)."""
    frames = _flickering_video(2)
    cfg = PipelineConfig(method=method)
    ve = VideoEnhancer(cfg, alpha=1.0)
    pipe = EnhancePipeline(cfg, force_jnp=True,
                           model_params=ve.model_params)
    for f in frames:
        d = np.abs(ve.process(f).astype(int) - pipe.enhance(f).astype(int))
        assert d.max() <= 1


def test_curve_video_constant_is_stable():
    frame = _flickering_video(1)[0]
    ve = VideoEnhancer(PipelineConfig(method="curve"), alpha=0.3)
    outs = [ve.process(frame) for _ in range(5)]
    np.testing.assert_array_equal(outs[-1], outs[-2])


def test_methods_without_temporal_carry_rejected():
    for method in ("fcn", "decom"):
        with pytest.raises(ValueError, match="enhance_stream"):
            VideoEnhancer(PipelineConfig(method=method))


def test_curve_video_carry_is_lowres():
    """VERDICT r2 item 4: the curve EMA carry must be the 1/ds LOW-RES maps
    (ds^2 x smaller than the round-2 full-res stack), bounded here so a
    regression back to full-res trips the assertion."""
    frame = _flickering_video(1, h=256, w=320)[0]
    sizes = {}
    for ds in (1, 2, 4):
        cfg = PipelineConfig(method="curve", curve_downsample=ds)
        ve = VideoEnhancer(cfg, alpha=0.3)
        ve.process(frame)
        it, c, hb, wb = ve._carry_shape
        assert (it, c) == (cfg.curve_iters, 3)
        assert ve.carry_bytes == it * c * hb * wb * 4
        sizes[ds] = ve.carry_bytes
    # /ds on both axes: ~16x at ds=4 and ~4x at ds=2, with slack for the
    # larger receptive-field halo the downsampled CNN needs (halo grows
    # with ds but is O(1) rows while the frame is O(H))
    assert sizes[4] * 8 <= sizes[1]
    assert sizes[2] * 3 <= sizes[1]


@pytest.mark.parametrize("method,ds", [("retinex", 1), ("hybrid", 1),
                                       ("curve", 1), ("curve", 2),
                                       ("curve", 8)])
def test_video_alpha_one_matches_stateless_pipeline(method, ds):
    """At alpha=1 the EMA keeps nothing, so every frame must come out as
    the stateless pipeline makes it — an independent route (single-block
    canvas, pipeline boost form) to the same pixels. Up to isolated u8
    rounding ties (the relit gain exp(g*log L - log L) vs exp((g-1)*log L));
    the outer denoise-radius columns are left out, where the video step
    replicates the gain's margin columns and the pipeline blurs across
    them."""
    from low_light_image_enhancement_tpu.config import denoise_radius

    frames = _flickering_video(3, h=64, w=64)
    cfg = PipelineConfig(method=method, curve_downsample=ds,
                         compute_dtype="float32")
    ve = VideoEnhancer(cfg, alpha=1.0)
    pipe = EnhancePipeline(cfg, model_params=ve.model_params)
    r = denoise_radius(cfg)
    for f in frames:
        d = np.abs(ve.process(f).astype(int) - pipe.enhance(f).astype(int))
        d = d[:, r:-r]
        assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_curve_video_ema_damps_map_changes():
    """What the curve-map EMA stabilizes is the adjustment FIELD (the
    low-res carry): between noisy frames of a static scene, the EMA'd carry
    must move ~alpha x as far as the per-frame maps do. (An output-level
    brightness-flicker metric is the wrong probe for curve: per-frame map
    adaptivity already boosts darker frames more, measured on synthetic
    flicker to cancel about as much as the EMA does.)"""
    frames = _flickering_video(2, h=40, w=64)
    cfg = PipelineConfig(method="curve", curve_downsample=2)
    ve_s = VideoEnhancer(cfg, alpha=0.2)
    ve_r = VideoEnhancer(cfg, alpha=1.0, model_params=ve_s.model_params)

    ve_s.process(frames[0])
    ve_r.process(frames[0])
    c1 = np.asarray(ve_s._state[1])
    np.testing.assert_allclose(c1, np.asarray(ve_r._state[1]), atol=1e-6)

    ve_s.process(frames[1])
    ve_r.process(frames[1])
    d_ema = np.abs(np.asarray(ve_s._state[1]) - c1).mean()
    d_raw = np.abs(np.asarray(ve_r._state[1]) - c1).mean()
    assert d_ema < 0.3 * d_raw  # ~= alpha * d_raw


# ---------------------------------------------------------------------------
# MultiStreamVideoEnhancer: S streams in one batched step
# ---------------------------------------------------------------------------

from low_light_image_enhancement_tpu.video import MultiStreamVideoEnhancer


def _stream_videos(s=3, n=4, h=40, w=64):
    """s independent flickering streams, n frames each."""
    vids = [_flickering_video(n, h, w, seed=17 + i) for i in range(s)]
    return [np.stack([vids[i][t] for i in range(s)]) for t in range(n)]


@pytest.mark.parametrize("method", ["retinex", "curve", "hybrid"])
def test_multistream_matches_independent_streams(method):
    """Each stream of the batched step must equal running it alone through
    VideoEnhancer (same jnp path; the batched compile may flip isolated u8
    rounding ties vs the single-frame compile, same tolerance as the other
    cross-jit-context parity tests). hybrid covers the rank-4
    gain-plane/pre-boosted path only multi-stream exercises."""
    s, n = 3, 4
    kw = {"curve_downsample": 2} if method in ("curve", "hybrid") else {}
    cfg = PipelineConfig(method=method, **kw)
    mv = MultiStreamVideoEnhancer(s, cfg, alpha=0.3)
    singles = [VideoEnhancer(cfg, alpha=0.3,
                             model_params=mv.model_params)
               for _ in range(s)]
    for frames in _stream_videos(s, n):
        outs = mv.process(frames)
        for i in range(s):
            ref = singles[i].process(frames[i])
            d = np.abs(outs[i].astype(int) - ref.astype(int))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_multistream_per_stream_reset():
    """reset(i) re-seeds ONLY stream i's EMA: after the cut, stream i
    matches a fresh enhancer while the untouched stream keeps matching its
    continuously-run reference."""
    s = 2
    cfg = PipelineConfig()
    mv = MultiStreamVideoEnhancer(s, cfg, alpha=0.2)
    cont = VideoEnhancer(cfg, alpha=0.2)   # mirrors stream 0
    batches = _stream_videos(s, n=5)
    for frames in batches[:3]:
        outs = mv.process(frames)
        ref0 = cont.process(frames[0])
        assert np.abs(outs[0].astype(int) - ref0.astype(int)).max() <= 1

    mv.reset(1)
    fresh = VideoEnhancer(cfg, alpha=0.2)  # stream 1 post-cut
    for frames in batches[3:]:
        outs = mv.process(frames)
        ref0 = cont.process(frames[0])
        ref1 = fresh.process(frames[1])
        assert np.abs(outs[0].astype(int) - ref0.astype(int)).max() <= 1
        assert np.abs(outs[1].astype(int) - ref1.astype(int)).max() <= 1


@pytest.mark.parametrize("method", ["curve", "retinex"])
def test_multistream_matches_single_streams_with_reset(method):
    """The batched video step vs one VideoEnhancer per stream, per stream —
    including a mid-sequence reset of stream 1 only (a fresh enhancer
    stands in for it), so one stream of the batch re-seeds while the
    other keeps its EMA."""
    s = 2
    kw = {"curve_downsample": 2} if method == "curve" else {}
    cfg = PipelineConfig(method=method, compute_dtype="float32", **kw)
    mv = MultiStreamVideoEnhancer(s, cfg, alpha=0.3)
    singles = [VideoEnhancer(cfg, alpha=0.3, model_params=mv.model_params)
               for _ in range(s)]
    for t, frames in enumerate(_stream_videos(s, n=4, h=48, w=64)):
        if t == 2:  # scene cut in stream 1 only
            mv.reset(1)
            singles[1].reset()
        got = mv.process(frames)
        for i in range(s):
            d = np.abs(got[i].astype(int)
                       - singles[i].process(frames[i]).astype(int))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_multistream_validation_and_carry():
    cfg = PipelineConfig(method="curve", curve_downsample=2)
    mv = MultiStreamVideoEnhancer(4, cfg)
    with pytest.raises(ValueError, match="n_streams"):
        mv.process(np.zeros((3, 40, 64, 3), np.uint8))
    frames = _stream_videos(4, n=1)[0]
    mv.process(frames)
    single = VideoEnhancer(cfg,
                           model_params=mv.model_params)
    single.process(frames[0])
    assert mv.carry_bytes == 4 * single.carry_bytes
    with pytest.raises(ValueError, match="frame size"):
        mv.process(np.zeros((4, 48, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="out of range"):
        mv.reset(7)
    with pytest.raises(ValueError, match="n_streams"):
        MultiStreamVideoEnhancer(0, cfg)


def test_multistream_conv_impl_is_stream_count_independent(monkeypatch):
    """conv_impl='auto' must resolve the same for any n_streams, so a
    stream's pixels never depend on how many streams share the device step
    (per-stream parity with a lone VideoEnhancer)."""
    cfg = PipelineConfig(method="curve", curve_downsample=2)
    single = VideoEnhancer(cfg)
    # far past curve's packed band (40): batch-S resolution would pick xla
    many = MultiStreamVideoEnhancer(64, cfg,
                                    model_params=single.model_params)
    single._build(40, 64)
    many._build(40, 64)
    assert single._resolved_cfg.conv_impl == "xla"
    assert many._resolved_cfg.conv_impl == single._resolved_cfg.conv_impl
