#!/usr/bin/env python
"""Headline benchmark: 600x400 (LOL-sized) enhancement throughput on one GPU.

Prints the card's name and power limit, then exactly ONE JSON line on
stdout:
  {"metric": "images_per_sec_600x400", "value": N, "unit": "images/sec",
   "device": {"platform": ..., "kind": ..., "count": ...}, ...}

Method: the batched u8-in/u8-out device program
(``EnhancePipeline.enhance_batch_device``) dispatched ``iters`` times on the
same input and synchronised once with ``block_until_ready``; the rate is the
median over ``repeats`` such windows. Needs a GPU: ``main`` exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np


def card_line() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def device_info() -> dict:
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def bench_throughput(
    batch: int = 48,
    h: int = 400,
    w: int = 600,
    repeats: int = 7,
    iters: int = 50,
    method: str = "retinex",
) -> dict:
    """Images/s of ``enhance_batch_device`` on the default device, which the
    result names."""
    import jax.numpy as jnp

    from low_light_image_enhancement_tpu.config import PipelineConfig
    from low_light_image_enhancement_tpu.data.synth import synth_batch
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    pipe = EnhancePipeline(PipelineConfig(method=method))
    lows, _ = synth_batch(min(batch, 8), h, w)
    lows = np.tile(lows, (-(-batch // lows.shape[0]), 1, 1, 1))[:batch]
    dev = jnp.asarray(lows)
    step = pipe.enhance_batch_device
    t0 = time.perf_counter()
    step(dev).block_until_ready()
    compile_s = time.perf_counter() - t0

    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step(dev)
        out.block_until_ready()
        rates.append(batch * iters / (time.perf_counter() - t0))
    value = float(np.median(rates))
    return {
        "images_per_sec": value,
        "rate_min": float(np.min(rates)),
        "rate_max": float(np.max(rates)),
        "rate_iqr_pct": float(
            100.0 * (np.percentile(rates, 75) - np.percentile(rates, 25))
            / value
        ),
        "batch": batch,
        "kernel": pipe._use_kernel,
        "compile_s": compile_s,
        "device": device_info(),
        "rates": rates,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=48)
    parser.add_argument("--repeats", type=int, default=7)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--method", default="retinex",
                        help="pipeline method to bench (headline: retinex)")
    parser.add_argument("--watchdog", type=float, default=1200.0,
                        help="seconds after which a run that has not "
                             "finished exits non-zero (0 disables)")
    args = parser.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"bench: needs a GPU, found {jax.devices()}", file=sys.stderr)
        return 2
    from low_light_image_enhancement_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    done = threading.Event()
    if args.watchdog > 0:
        def _abort():
            if not done.wait(args.watchdog):
                print(f"bench: no result after {args.watchdog:.0f} s",
                      file=sys.stderr, flush=True)
                os._exit(3)

        threading.Thread(target=_abort, daemon=True).start()

    print(card_line(), flush=True)
    res = bench_throughput(batch=args.batch, repeats=args.repeats,
                           iters=args.iters, method=args.method)
    done.set()
    print(json.dumps({
        "metric": "images_per_sec_600x400",
        "value": res["images_per_sec"],
        "unit": "images/sec",
        "device": res["device"],
        "min": res["rate_min"],
        "max": res["rate_max"],
        "iqr_pct": res["rate_iqr_pct"],
        "n_repeats": len(res["rates"]),
        "kernel": res["kernel"],
        "compile_s": res["compile_s"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
