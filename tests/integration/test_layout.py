"""Layout persistence: the planar I/O path must be bit-identical to the
default HWC contract — only WHERE the layout conversion runs (device vs
prefetch-worker host threads) changes.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from low_light_image_enhancement_tpu.config import PipelineConfig
from low_light_image_enhancement_tpu.data.synth import synth_batch
from low_light_image_enhancement_tpu.io.prefetch import from_planar, to_planar
from low_light_image_enhancement_tpu.pipeline import EnhancePipeline


def _batch(b=2, h=48, w=64):
    lows, _ = synth_batch(b, h, w)
    return lows


def test_to_from_planar_roundtrip():
    x = _batch()
    p = to_planar(x)
    assert p.shape == (2, 3, 48, 64) and p.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(from_planar(p), x)


@pytest.mark.parametrize("method", ["retinex", "curve", "hybrid"])
def test_planar_program_matches_hwc(method):
    """planar_io skips the device transposes; outputs must be identical."""
    cfg = PipelineConfig(method=method, curve_downsample=2)
    pipe = EnhancePipeline(cfg, force_jnp=True)
    x = _batch()
    hwc = np.asarray(pipe.enhance_batch_device(jnp.asarray(x)))
    pl = np.asarray(
        pipe.enhance_batch_device_planar(jnp.asarray(to_planar(x)))
    )
    np.testing.assert_array_equal(from_planar(pl), hwc)


def test_planar_program_matches_hwc_pallas_interpret():
    cfg = PipelineConfig()
    pipe = EnhancePipeline(cfg, pallas_interpret=True)
    x = _batch()
    hwc = np.asarray(pipe.enhance_batch_device(jnp.asarray(x)))
    pl = np.asarray(
        pipe.enhance_batch_device_planar(jnp.asarray(to_planar(x)))
    )
    np.testing.assert_array_equal(from_planar(pl), hwc)


def test_kernel_path_matches_plain_path():
    """The fused kernel (interpreter) and the plain graph through the same
    pipeline entry: equal up to isolated u8 rounding ties."""
    x = _batch()
    got = EnhancePipeline(PipelineConfig(), pallas_interpret=True
                          ).enhance_batch(x)
    want = EnhancePipeline(PipelineConfig(), force_jnp=True).enhance_batch(x)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_enhance_stream_rejects_unknown_staging():
    pipe = EnhancePipeline(PipelineConfig(), force_jnp=True)
    with pytest.raises(ValueError, match="staging"):
        next(pipe.enhance_stream(iter(_batch(1)), staging="canvas"))


@pytest.mark.parametrize("staging", ["hwc", "planar"])
def test_enhance_stream_staging_modes_identical(staging):
    cfg = PipelineConfig()
    pipe = EnhancePipeline(cfg, pallas_interpret=True)
    frames = [f for f in _batch(4)]
    ref = [pipe.enhance(f) for f in frames]
    out = list(pipe.enhance_stream(iter(frames), staging=staging))
    assert len(out) == len(ref)
    for got, want in zip(out, ref):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("staging", ["hwc", "planar"])
def test_enhance_stream_staging_batches(staging):
    cfg = PipelineConfig()
    pipe = EnhancePipeline(cfg, pallas_interpret=True)
    batches = [_batch(2), _batch(2)]
    ref = [pipe.enhance_batch(b) for b in batches]
    out = list(pipe.enhance_stream(iter(batches), staging=staging,
                                   workers=2))
    for got, want in zip(out, ref):
        np.testing.assert_array_equal(got, want)


def test_planar_path_with_data_shards():
    """planar I/O composes with DP batch sharding (data_shards > 1): the
    batch-sharded planar program matches the unsharded planar program."""
    cfg = PipelineConfig(data_shards=2)
    pipe = EnhancePipeline(cfg, force_jnp=True)
    x = to_planar(_batch(4))
    out = np.asarray(pipe.enhance_batch_device_planar(jnp.asarray(x)))
    ref = np.asarray(
        EnhancePipeline(PipelineConfig(), force_jnp=True)
        .enhance_batch_device_planar(jnp.asarray(x))
    )
    np.testing.assert_array_equal(out, ref)
