"""Two-process jax.distributed coverage (SURVEY.md §4): spawn 2 local CPU
processes, build a global mesh, run one sharded zero-reference train step —
both processes must agree on the loss (gradients all-reduced over the
process boundary via Gloo/DCN path)."""

import os
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent(
    """
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid = int(sys.argv[1])
    from low_light_image_enhancement_tpu.parallel.distributed import (
        initialize_distributed, global_batch_from_local)
    initialize_distributed("localhost:12357", num_processes=2, process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from low_light_image_enhancement_tpu.train import (
        TrainConfig, init_train_state, make_train_step)
    from low_light_image_enhancement_tpu.parallel import make_mesh

    assert jax.device_count() == 2, jax.devices()
    mesh = make_mesh(n_data=2, n_spatial=1)
    tcfg = TrainConfig(features=8, n_iter=2, batch_size=2, crop=16, steps=1)
    params, opt_state = init_train_state(tcfg, seed=0)
    step = make_train_step(tcfg, mesh)
    # each process contributes its local half of the global batch
    local = np.random.default_rng(pid).random((1, 3, 16, 16), np.float32)
    batch = global_batch_from_local(mesh, local, P(("data", "spatial")))
    params, opt_state, metrics = step(params, opt_state, batch)
    print(f"RESULT {pid} {float(metrics['loss']):.6f}", flush=True)
    """
)


def test_two_process_sharded_train_step(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    # The parent test session typically exports
    # XLA_FLAGS=--xla_force_host_platform_device_count=8 (the fake-device
    # idiom, SURVEY.md §4); inherited by the workers it would give each
    # process 8 local devices and break the 2-device global mesh below.
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=150)[0] for p in procs]
    losses = {}
    for out, p in zip(outs, procs):
        assert p.returncode == 0, out[-2000:]
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, loss = line.split()
                losses[pid] = float(loss)
    assert set(losses) == {"0", "1"}, outs
    assert abs(losses["0"] - losses["1"]) < 1e-6


_SPATIAL_WORKER = textwrap.dedent(
    """
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)   # 4 local devices/process
    pid = int(sys.argv[1])
    from low_light_image_enhancement_tpu.parallel.distributed import (
        initialize_distributed)
    initialize_distributed("localhost:12361", num_processes=2, process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from low_light_image_enhancement_tpu.config import PipelineConfig
    from low_light_image_enhancement_tpu.parallel import (
        enhance_spatial_sharded, make_mesh)
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    assert jax.device_count() == 8 and jax.local_device_count() == 4
    mesh = make_mesh(n_data=1, n_spatial=8)

    # deterministic input known to BOTH processes; rows shard over the
    # 8-device spatial axis, so ppermute halos at the 4|5 seam cross the
    # process boundary over the DCN transport (SURVEY.md 3.4)
    h, w = 64, 96
    full = np.random.default_rng(7).random((2, 3, h, w)).astype(np.float32)
    rows_per_proc = h // 2
    local = full[:, :, pid * rows_per_proc : (pid + 1) * rows_per_proc]
    x = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(None, None, "spatial", None)), local)

    for method in ("retinex", "curve"):
        cfg = PipelineConfig(method=method, compute_dtype="float32")
        params = (None if method == "retinex"
                  else EnhancePipeline._default_params(cfg, 0))
        got = enhance_spatial_sharded(x, cfg, mesh, model_params=params)

        # single-device reference on a local 1-device mesh
        ref_mesh = make_mesh(n_data=1, n_spatial=1,
                             devices=jax.local_devices()[:1])
        want = np.asarray(enhance_spatial_sharded(
            jnp.asarray(full), cfg, ref_mesh, model_params=params))
        for shard in got.addressable_shards:
            a = np.asarray(shard.data)
            b = want[shard.index]
            np.testing.assert_allclose(a, b, atol=2e-5, err_msg=method)
    print(f"SPATIAL-OK {pid}", flush=True)
    """
)


def test_two_process_spatial_inference_halos_cross_processes(tmp_path):
    """VERDICT r2 item 6: spatially-sharded inference with the halo
    exchange crossing the process boundary (2 processes x 4 devices,
    retinex AND a learned method) must match the single-process output."""
    script = tmp_path / "spatial_worker.py"
    script.write_text(_SPATIAL_WORKER)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for out, p in zip(outs, procs):
        assert p.returncode == 0, out[-3000:]
        assert any(line.startswith("SPATIAL-OK") for line in out.splitlines())
