"""Fused retinex kernel vs XLA's plain graph, end to end on the GPU.

Times ``EnhancePipeline.enhance_batch_device`` with the kernel and with the
plain ``jax.numpy`` graph (``force_jnp=True``) at 600x400 b48, 1080p b8 and
4K b1, in turns (plain, kernel, kernel, plain), and compares their outputs.
``--tiles`` also times the kernel alone at several tile shapes.

    python scripts/bench_retinex_kernel.py [--tiles] [--iters 50]

Needs a GPU; exits non-zero without one. Writes
``chiprun_out/retinex_kernel.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = ((48, 400, 600), (8, 1080, 1920), (1, 2160, 3840))
TILES = ((8, 128, 4), (16, 64, 4), (16, 128, 4), (32, 64, 4), (8, 64, 2),
         (32, 128, 8), (16, 32, 2))


def _time(fn, x, iters):
    fn(x).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(iters):
        y = fn(x)
    y.block_until_ready()
    return (time.perf_counter() - t0) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--tiles", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    if jax.devices()[0].platform != "gpu":
        print(f"no GPU: {jax.devices()}", file=sys.stderr)
        return 2
    from low_light_image_enhancement_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    from low_light_image_enhancement_tpu import EnhancePipeline, PipelineConfig
    from low_light_image_enhancement_tpu.data.synth_device import (
        synth_pair_batch,
    )
    from low_light_image_enhancement_tpu.ops.colorspace import quantize_u8
    from low_light_image_enhancement_tpu.kernels.fused_enhance import (
        fused_retinex,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card)
    cfg = PipelineConfig()
    kern = EnhancePipeline(cfg)
    plain = EnhancePipeline(cfg, force_jnp=True)
    assert kern._use_kernel and not plain._use_kernel
    rows = []
    for b, h, w in SHAPES:
        low, _ = synth_pair_batch(jax.random.PRNGKey(0), b, h, w)
        x = jnp.transpose(quantize_u8(low), (0, 2, 3, 1))
        t0 = time.perf_counter()
        yk = np.asarray(kern.enhance_batch_device(x))
        tk_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        yp = np.asarray(plain.enhance_batch_device(x))
        tp_compile = time.perf_counter() - t0
        d = np.abs(yk.astype(np.int16) - yp.astype(np.int16))
        fk, fp = kern.enhance_batch_device, plain.enhance_batch_device
        ts = {"plain": [], "kernel": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            ts[name].append(_time(fk if name == "kernel" else fp, x,
                                  args.iters))
        row = {
            "shape": [b, h, w],
            "plain_s": ts["plain"], "kernel_s": ts["kernel"],
            "plain_img_per_s": b / min(ts["plain"]),
            "kernel_img_per_s": b / min(ts["kernel"]),
            "speedup": min(ts["plain"]) / min(ts["kernel"]),
            "max_abs_u8": int(d.max()), "frac_diff": float((d > 0).mean()),
            "compile_s": {"kernel": tk_compile, "plain": tp_compile},
        }
        if args.tiles:
            tiles = {}
            for t in TILES:
                fn = jax.jit(lambda v, t=t: jnp.transpose(fused_retinex(
                    jnp.transpose(v, (0, 3, 1, 2)), cfg, tile=t),
                    (0, 2, 3, 1)))
                tiles[str(t)] = _time(fn, x, args.iters)
            row["kernel_alone_s_by_tile"] = tiles
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/retinex_kernel.json", "w") as f:
        json.dump({"card": card, "device_kind": jax.devices()[0].device_kind,
                   "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
