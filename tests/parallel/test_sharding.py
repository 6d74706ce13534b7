"""Distributed logic on 8 fake CPU devices (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P
from jax import shard_map

from low_light_image_enhancement_tpu.config import PipelineConfig
from low_light_image_enhancement_tpu.core import MARGIN, enhance_core_padded
from low_light_image_enhancement_tpu.parallel import (
    enhance_spatial_sharded,
    halo_pad_local,
    make_mesh,
    shard_batch_fn,
)
from low_light_image_enhancement_tpu.pipeline import pad_planar


def test_eight_fake_devices_present():
    assert len(jax.devices()) == 8


def test_make_mesh_shapes():
    mesh = make_mesh(n_spatial=4)
    assert mesh.shape == {"data": 2, "spatial": 4}
    mesh = make_mesh(n_data=8)
    assert mesh.shape == {"data": 8, "spatial": 1}
    with pytest.raises(ValueError):
        make_mesh(n_data=16, n_spatial=1)


def test_halo_pad_local_matches_global_edge_pad():
    """Sharded halo exchange must rebuild exactly the rows a single device
    would see from jnp.pad(mode='edge')."""
    mesh = make_mesh(n_data=1, n_spatial=8)
    rng = np.random.default_rng(0)
    m = 3
    x = jnp.asarray(rng.random((2, 64, 16), dtype=np.float32))  # (B, H, W)

    def local(xl):
        return halo_pad_local(xl, m, "spatial")

    got = shard_map(
        local, mesh=mesh, in_specs=P(None, "spatial", None),
        out_specs=P(None, "spatial", None),
    )(x)
    # got: per-shard canvases concatenated: 8 * (8 + 2m) rows
    got = np.asarray(got).reshape(2, 8, 8 + 2 * m, 16)
    want_pad = np.asarray(jnp.pad(x, ((0, 0), (m, m), (0, 0)), mode="edge"))
    for s in range(8):
        want = want_pad[:, s * 8 : s * 8 + 8 + 2 * m]
        np.testing.assert_array_equal(got[:, s], want)


@pytest.mark.parametrize("n_spatial", [2, 4, 8])
def test_spatial_sharded_matches_single_device(n_spatial):
    cfg = PipelineConfig()
    mesh = make_mesh(n_data=1, n_spatial=n_spatial)
    rng = np.random.default_rng(1)
    h, w = 96, 130
    x = jnp.asarray(rng.random((2, 3, h, w), dtype=np.float32))

    got = np.asarray(enhance_spatial_sharded(x, cfg, mesh))

    xp = pad_planar(x, MARGIN)
    want = np.asarray(
        enhance_core_padded(xp, cfg)[..., MARGIN : MARGIN + h, MARGIN : MARGIN + w]
    )
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_spatial_sharded_with_data_axis():
    cfg = PipelineConfig()
    mesh = make_mesh(n_data=2, n_spatial=4)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.random((2, 3, 48, 64), dtype=np.float32))
    got = np.asarray(enhance_spatial_sharded(x, cfg, mesh))
    single = make_mesh(n_data=1, n_spatial=1, devices=jax.devices()[:1])
    want = np.asarray(enhance_spatial_sharded(x, cfg, single))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_spatial_sharded_u8_matches_pipeline_bit_exact():
    """u8 sharded path (u8 halos + per-shard fused kernel, interpreter)
    must reproduce the single-device u8 pipeline exactly."""
    from low_light_image_enhancement_tpu.data.synth import synth_batch
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    cfg = PipelineConfig()
    mesh = make_mesh(n_data=1, n_spatial=4)
    lows, _ = synth_batch(2, 64, 100)
    x_u8 = jnp.transpose(jnp.asarray(lows), (0, 3, 1, 2))  # u8 planar

    got = np.asarray(
        enhance_spatial_sharded(x_u8, cfg, mesh, use_kernel=True,
                                interpret=True)
    )
    want = EnhancePipeline(cfg, pallas_interpret=True).enhance_batch(lows)
    want_planar = np.transpose(want, (0, 3, 1, 2))
    np.testing.assert_array_equal(got, want_planar)


def test_spatial_sharded_u8_plain_matches_pipeline():
    """u8 in on the plain path: each shard converts at its own boundary and
    the result equals the single-device plain pipeline exactly; f32 input
    to the kernel is refused."""
    from low_light_image_enhancement_tpu.data.synth import synth_batch
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    mesh = make_mesh(n_data=1, n_spatial=2)
    lows, _ = synth_batch(1, 48, 40)
    x_u8 = jnp.transpose(jnp.asarray(lows), (0, 3, 1, 2))
    got = np.asarray(enhance_spatial_sharded(x_u8, PipelineConfig(), mesh))
    want = EnhancePipeline(PipelineConfig(), force_jnp=True
                           ).enhance_batch(lows)
    np.testing.assert_array_equal(got, np.transpose(want, (0, 3, 1, 2)))
    with pytest.raises(ValueError, match="uint8"):
        enhance_spatial_sharded(jnp.zeros((1, 3, 16, 16)), PipelineConfig(),
                                mesh, use_kernel=True, interpret=True)


@pytest.mark.parametrize(
    "method,n_spatial,h,w",
    [
        ("curve", 2, 64, 96),
        ("curve", 4, 64, 96),
        ("hybrid", 2, 64, 96),
        ("decom", 4, 64, 96),
        ("fcn", 2, 160, 96),  # dilation-stack radius 64 -> 72-row halo
    ],
)
def test_learned_spatial_sharded_matches_pipeline(method, n_spatial, h, w):
    """Learned methods under spatial sharding (halo = the net's receptive
    field, VERDICT r1 item 2) reproduce the single-device pipeline u8 output
    bit-exactly: both run blocks.enhance_learned_block, and halo exchange
    rebuilds the identical block rows."""
    from low_light_image_enhancement_tpu.data.synth import synth_batch
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    # f32 pinned: these tests bound the shard-vs-single u8 tie-flip rate at
    # 1e-3, which holds for f32 FMA-reassociation noise; bf16 convs (the
    # inference default) flip ~10% of pixels by 1 u8 for dtype reasons
    # unrelated to sharding
    cfg = PipelineConfig(method=method, compute_dtype="float32")
    pipe = EnhancePipeline(cfg, force_jnp=True)
    mesh = make_mesh(n_data=1, n_spatial=n_spatial)
    lows, _ = synth_batch(2, h, w)

    x_u8 = jnp.transpose(jnp.asarray(lows), (0, 3, 1, 2))
    got = np.asarray(
        enhance_spatial_sharded(
            x_u8, cfg, mesh, model_params=pipe.model_params
        )
    )
    want = np.transpose(pipe.enhance_batch(lows), (0, 3, 1, 2))
    # XLA fuses the same f32 chain differently inside shard_map than in the
    # pipeline jit (FMA contraction of the hybrid exp/log boost and of the
    # epan range weight's 1 - d*d*k); last-ulp differences flip a handful of
    # u8 rounding ties (~0.02% of pixels, measured identical even with
    # n_spatial=1, i.e. with bit-identical block values and no collectives).
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_learned_spatial_sharded_downsampled_curves():
    """curve_downsample > 1: shard-local resample grids must coincide with
    the single-device grid (halo and rows are multiples of 8*ds)."""
    from low_light_image_enhancement_tpu.data.synth import synth_batch
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    cfg = PipelineConfig(method="curve", curve_downsample=2,
                         compute_dtype="float32")
    pipe = EnhancePipeline(cfg, force_jnp=True)
    mesh = make_mesh(n_data=1, n_spatial=2)
    lows, _ = synth_batch(1, 96, 80)
    x_u8 = jnp.transpose(jnp.asarray(lows), (0, 3, 1, 2))
    got = np.asarray(
        enhance_spatial_sharded(
            x_u8, cfg, mesh, model_params=pipe.model_params
        )
    )
    want = np.transpose(pipe.enhance_batch(lows), (0, 3, 1, 2))
    # Grid alignment guarantees the resample consumes identical low-res map
    # values on both paths, but NOT identical floats: as in the full-res test
    # above, XLA contracts the f32 chain into different FMA trees inside
    # shard_map vs the pipeline jit, and isolated u8 rounding ties flip
    # (measured: 1 px in 23,040 on one box). Same documented bound as the
    # sibling: |Δ| <= 1 u8 step on < 0.1% of pixels.
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_learned_sharded_rejects_too_many_shards():
    """A shard must own at least the receptive-field halo's worth of rows."""
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    cfg = PipelineConfig(method="fcn", compute_dtype="float32")
    pipe = EnhancePipeline(cfg, force_jnp=True)
    mesh = make_mesh(n_data=1, n_spatial=8)
    x = jnp.zeros((1, 3, 64, 64), jnp.float32)
    with pytest.raises(ValueError, match="receptive-field halo"):
        enhance_spatial_sharded(x, cfg, mesh, model_params=pipe.model_params)


def test_shard_batch_fn_runs_and_matches():
    mesh = make_mesh()
    f = lambda x: jnp.sin(x) * 2.0
    wrapped = shard_batch_fn(f, mesh)
    x = jnp.arange(16.0).reshape(16, 1)
    np.testing.assert_allclose(
        np.asarray(wrapped(x)), np.asarray(f(x)), atol=1e-6
    )
