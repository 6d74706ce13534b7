"""Structural data-parallel guarantees on the 8-fake-device mesh: what
transfers to a multi-device host is that the batch is evenly sharded
across every device and the compiled step contains no resharding
collectives — batch DP must be embarrassingly parallel."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from low_light_image_enhancement_tpu.config import PipelineConfig
from low_light_image_enhancement_tpu.data.synth import synth_batch
from low_light_image_enhancement_tpu.parallel import make_mesh, shard_batch_fn
from low_light_image_enhancement_tpu.pipeline import _enhance_u8_batch


def _jnp_enhance(h, w):
    cfg = PipelineConfig()
    return functools.partial(
        _enhance_u8_batch, cfg=cfg, use_kernel=False, interpret=False,
    )


def test_dp_batch_sharded_on_all_devices_and_collective_free():
    h, w = 48, 64
    mesh = make_mesh(n_data=8, n_spatial=1)
    fn = _jnp_enhance(h, w)
    lows, _ = synth_batch(8, h, w)
    x = jax.device_put(jnp.asarray(lows), NamedSharding(mesh, P("data")))

    lowered = jax.jit(lambda v: fn(v, None)).lower(x)
    compiled = lowered.compile()
    hlo = compiled.as_text()
    for coll in ("all-gather", "all-reduce", "collective-permute",
                 "all-to-all"):
        assert coll not in hlo, f"batch-DP step contains {coll}"

    out = jax.jit(lambda v: fn(v, None))(x)
    # every device holds exactly B/N of the batch
    shards = out.addressable_shards
    assert len(shards) == 8
    assert sorted(s.device.id for s in shards) == list(range(8))
    for s in shards:
        assert s.data.shape == (1, h, w, 3)


def test_shard_batch_fn_output_matches_and_is_sharded():
    h, w = 48, 64
    mesh = make_mesh(n_data=8, n_spatial=1)
    fn = _jnp_enhance(h, w)
    lows, _ = synth_batch(8, h, w)
    step = shard_batch_fn(lambda v: fn(v, None), mesh)
    got = step(lows)
    assert len(got.addressable_shards) == 8
    want = jax.jit(lambda v: fn(v, None))(jnp.asarray(lows))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_spatially_sharded_training_matches_unsharded():
    """spatial_batch=True shards crop ROWS over the "spatial" axis; GSPMD
    inserts conv halo exchanges, so one step must reproduce the unsharded
    step's updated params up to reduction reordering."""
    from low_light_image_enhancement_tpu.train import (
        TrainConfig,
        init_train_state,
        make_paired_curve_train_step,
    )

    # f32 compute: this test pins the SHARDING math (halo exchange +
    # partial reductions), so it runs the dtype where reduction
    # reordering stays under a tight tolerance — the round-5 bf16
    # training default reorders bf16 conv reductions across shards by
    # ~2e-4, which is expected dtype noise, not a sharding bug.
    tcfg = TrainConfig(features=8, n_iter=2, batch_size=2, crop=32, steps=1,
                       compute_dtype="float32")
    rng = np.random.default_rng(0)
    low = jnp.asarray(rng.random((2, 3, 32, 32), np.float32) * 0.4)
    high = jnp.clip(low * 2.5, 0.0, 1.0)

    params0, opt0 = init_train_state(tcfg, seed=0)
    p_ref, _, m_ref = make_paired_curve_train_step(tcfg)(
        params0, opt0, low, high
    )

    mesh = make_mesh(n_data=2, n_spatial=4)
    p_sp, _, m_sp = make_paired_curve_train_step(
        tcfg, mesh, spatial_batch=True
    )(params0, opt0, low, high)

    np.testing.assert_allclose(
        float(m_sp["loss"]), float(m_ref["loss"]), rtol=1e-5
    )
    for a, b in zip(jax.tree_util.tree_leaves(p_ref),
                    jax.tree_util.tree_leaves(p_sp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)


def test_pipeline_data_shards_parity_and_padding():
    """config.data_shards routes EnhancePipeline through the batch-sharded
    placement: bit-identical output vs unsharded, batch sharded over the
    data mesh, non-divisible batches padded + cropped at the host API."""
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    imgs = synth_batch(6, 40, 64)[0]  # 6 images; 6 % 4 != 0
    base = EnhancePipeline(PipelineConfig())
    dp = EnhancePipeline(PipelineConfig(data_shards=4))

    # device-level: divisible batch is accepted and sharded
    out_dev = dp.enhance_batch_device(jnp.asarray(imgs[:4]))
    shardings = {d.device for d in out_dev.addressable_shards}
    assert len(shardings) == 4
    np.testing.assert_array_equal(
        np.asarray(out_dev), base.enhance_batch(imgs[:4])
    )
    import pytest

    with pytest.raises(ValueError):
        dp.enhance_batch_device(jnp.asarray(imgs))  # 6 % 4

    # host-level: padding + crop hides divisibility
    np.testing.assert_array_equal(
        dp.enhance_batch(imgs), base.enhance_batch(imgs)
    )


def test_config_rejects_combined_pipeline_sharding():
    import pytest

    with pytest.raises(ValueError):
        PipelineConfig(spatial_shards=2, data_shards=2)
    with pytest.raises(ValueError):
        PipelineConfig(data_shards=0)
