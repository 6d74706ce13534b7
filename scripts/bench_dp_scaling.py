#!/usr/bin/env python
"""Data-parallel scaling measurement on a virtual CPU mesh (VERDICT r1 #7).

On a CPU host the 8 virtual devices time-share the cores, so a wall-clock
1->8-device speedup curve means nothing here. What IS measurable and
transfers to a multi-device host:

  * weak-scaling overhead — hold per-device batch constant, grow the device
    count; on one core the ideal time is n * t1 (pure serialization), so
    overhead_factor(n) = t(n) / (n * t1) isolates the cost the sharded
    program ADDS over the single-device program (resharding, dispatch,
    runtime). ~1.0 means the per-device program is unchanged — and since the
    structural tests (tests/parallel/test_dp_scaling.py) prove the step
    contains no cross-device collectives, n such programs on n real devices
    run concurrently at efficiency ~= 1 / overhead_factor.

Prints one JSON line with t1, the overhead curve, and the implied
multi-device efficiency.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np


def measure(per_dev_batch: int, h: int, w: int, repeats: int) -> dict:
    from low_light_image_enhancement_tpu.config import PipelineConfig
    from low_light_image_enhancement_tpu.data.synth import synth_batch
    from low_light_image_enhancement_tpu.parallel import (
        make_mesh,
        shard_batch_fn,
    )
    from low_light_image_enhancement_tpu.pipeline import _enhance_u8_batch

    cfg = PipelineConfig()
    fn = functools.partial(
        _enhance_u8_batch, cfg=cfg, use_kernel=False, interpret=False,
    )
    base, _ = synth_batch(per_dev_batch, h, w)

    def timed(n_dev: int) -> float:
        batch = np.tile(base, (n_dev, 1, 1, 1))
        mesh = make_mesh(n_data=n_dev, n_spatial=1,
                         devices=jax.devices()[:n_dev])
        step = shard_batch_fn(lambda x: fn(x, None), mesh)
        step(batch).block_until_ready()  # compile
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            step(batch).block_until_ready()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    t1 = timed(1)
    overhead = {}
    for n in (2, 4, 8):
        overhead[str(n)] = round(timed(n) / (n * t1), 3)
    return {
        "metric": "dp_weak_scaling_overhead_cpu_mesh",
        "per_device_batch": per_dev_batch,
        "resolution": f"{h}x{w}",
        "t1_sec": round(t1, 4),
        "overhead_factor": overhead,
        "implied_8dev_efficiency": round(1.0 / overhead["8"], 3),
        "note": "1-core host: overhead_factor isolates sharded-program cost "
                "over n serialized single-device programs; see docstring",
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-dev-batch", type=int, default=8)
    ap.add_argument("--size", type=int, nargs=2, default=(400, 600))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if args.quick:
        args.per_dev_batch, args.size, args.repeats = 2, (96, 128), 2
    print(json.dumps(measure(args.per_dev_batch, *args.size, args.repeats)))


if __name__ == "__main__":
    main()
