"""SpatialShardedVideoEnhancer: temporally-stable video with rows sharded
over the mesh's spatial axis (config 5 x config 4).

The contract under test: per-frame outputs match a single-device
VideoEnhancer over a multi-frame sequence — i.e. the per-shard EMA carries
evolve exactly as the single-device carry does on every row the tail
consumes — up to the usual cross-jit-context u8 rounding ties (f32 compute pinned
in the learned-method parity tests, same rationale as
test_sharding.py: bf16 convs flip ~10% of pixels by 1 u8 for dtype
reasons unrelated to sharding).
Runs on the 8-fake-device CPU mesh from conftest.
"""

import jax
import numpy as np
import pytest

from low_light_image_enhancement_tpu.config import PipelineConfig
from low_light_image_enhancement_tpu.data.synth import synth_pair
from low_light_image_enhancement_tpu.parallel import (
    SpatialShardedVideoEnhancer,
    make_mesh,
)
from low_light_image_enhancement_tpu.video import VideoEnhancer

def _flicker_frames(n=4, h=96, w=64, seed=3):
    rng = np.random.default_rng(seed)
    _, gt = synth_pair(0, h, w, seed=seed)
    scene = gt.astype(np.float32) / 255.0
    out = []
    for _ in range(n):
        level = 0.15 + 0.10 * rng.random()
        f = np.clip(scene * level + rng.normal(0, 0.005, scene.shape), 0, 1)
        out.append((f * 255).astype(np.uint8))
    return out


def _assert_tie_close(a, b):
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("n_spatial,h", [(4, 96), (8, 128)])
def test_sharded_retinex_video_matches_single_device(n_spatial, h):
    mesh = make_mesh(n_data=1, n_spatial=n_spatial)
    cfg = PipelineConfig()
    sve = SpatialShardedVideoEnhancer(mesh, cfg, alpha=0.3)
    ve = VideoEnhancer(cfg, alpha=0.3)
    for f in _flicker_frames(h=h):
        _assert_tie_close(sve.process(f), ve.process(f))


def test_sharded_curve_video_matches_single_device():
    # 2 shards: curve's receptive-field halo (>=16 rows at ds=2) needs
    # rows/shard >= halo, so a 96-row frame caps the shard count.
    mesh = make_mesh(n_data=1, n_spatial=2)
    cfg = PipelineConfig(method="curve", curve_downsample=2,
                         compute_dtype="float32")
    sve = SpatialShardedVideoEnhancer(mesh, cfg, alpha=0.3)
    ve = VideoEnhancer(cfg, alpha=0.3,
                       model_params=sve.model_params)
    for f in _flicker_frames():
        _assert_tie_close(sve.process(f), ve.process(f))


def test_sharded_hybrid_video_matches_single_device():
    mesh = make_mesh(n_data=1, n_spatial=2)
    cfg = PipelineConfig(method="hybrid", curve_downsample=2,
                         compute_dtype="float32")
    sve = SpatialShardedVideoEnhancer(mesh, cfg, alpha=0.3)
    ve = VideoEnhancer(cfg, alpha=0.3,
                       model_params=sve.model_params)
    for f in _flicker_frames():
        _assert_tie_close(sve.process(f), ve.process(f))


def test_sharded_hybrid_video_matches_single_device():
    """Hybrid (boost + CNN + tail) per shard, halo-exchanged rows, against
    the single-device video step."""
    mesh = make_mesh(n_data=1, n_spatial=2)
    cfg = PipelineConfig(method="hybrid", compute_dtype="float32")
    sk = SpatialShardedVideoEnhancer(mesh, cfg, alpha=0.3)
    ve = VideoEnhancer(cfg, alpha=0.3, model_params=sk.model_params)
    for f in _flicker_frames(n=3):
        _assert_tie_close(sk.process(f), ve.process(f))


def test_sharded_video_reset_and_guards():
    mesh = make_mesh(n_data=1, n_spatial=2)
    sve = SpatialShardedVideoEnhancer(mesh, PipelineConfig(), alpha=0.3)
    frames = _flicker_frames(n=2)
    o1 = sve.process(frames[0])
    sve.process(frames[1])
    sve.reset()
    # after reset the EMA re-seeds: first-frame output reproduces exactly
    np.testing.assert_array_equal(sve.process(frames[0]), o1)
    with pytest.raises(ValueError, match="frame size"):
        sve.process(np.zeros((32, 48, 3), np.uint8))
    with pytest.raises(ValueError, match="H, W, 3"):
        sve.process(np.zeros((96, 64, 4), np.uint8))
    with pytest.raises(ValueError, match="spatial"):
        import jax as _jax
        from jax.sharding import Mesh

        SpatialShardedVideoEnhancer(
            Mesh(np.asarray(_jax.devices()[:2]).reshape(2), ("rows",)),
            PipelineConfig(),
        )


def test_sharded_video_carry_is_per_shard_and_compact():
    mesh = make_mesh(n_data=1, n_spatial=2)
    cfg = PipelineConfig(method="curve", curve_downsample=2)
    sve = SpatialShardedVideoEnhancer(mesh, cfg)
    sve.process(_flicker_frames(n=1)[0])
    n_sp, it, c, hb_ds, wp_ds = sve._carry_shape
    assert n_sp == 2 and (it, c) == (cfg.curve_iters, 3)
    # low-res carry: each shard holds its canvas / ds
    assert sve.carry_bytes == n_sp * it * c * hb_ds * wp_ds * 4
