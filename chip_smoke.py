#!/usr/bin/env python
"""End-to-end smoke run of llie on an NVIDIA GPU.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the multi-card phase only

Phases (one process; each fails loudly, and the run fails if any did):

1. device  - the default devices must be GPUs (exit 2 otherwise, nothing
             else runs); prints the card's name and power limit.
2. enhance - ``llie enhance`` in-process on a 600x400 PNG, every method.
3. parity  - the retinex kernel and the learned methods against a plain
             float32 reference run under matmul precision "highest".
4. serve   - HTTP server in a thread: concurrent POST /enhance at 600x400
             and 1080p, GET /healthz, GET /stats.
5. video   - VideoEnhancer on 8 1080p frames (retinex, hybrid) and a
             4-stream MultiStreamVideoEnhancer.
6. raw     - enhance_raw on 600x400 RGGB mosaics, kernel vs plain graph.
7. train   - 5 steps of the curve trainer at 512x512, batch 64.

``--cards 4`` runs the data-parallel and spatially sharded paths on a flat
("data", "spatial") mesh of four cards, each against the same work on one
card. The last line of stdout is the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances, each with its reason:
# - U8_STEPS: the kernel's exp/log (libdevice) and XLA's differ in the last
#   ulps, and learned methods at float32 reorder conv sums, so isolated
#   u8 rounding ties may flip by one step.
# - TIE_SHARE: the share of pixels allowed at that one step.
# - PSNR_GAP_DB: the BASELINE.json parity bound against the reference.
U8_STEPS = 1
TIE_SHARE = 1e-3
PSNR_GAP_DB = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def psnr_db(a, b) -> float:
    """Mean per-image PSNR of u8 (B, H, W, 3) batches."""
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = np.maximum(np.mean(d * d, axis=(1, 2, 3)), 1e-12)
    return float(np.mean(10.0 * np.log10(255.0 ** 2 / mse)))


def compare(name, got, want, steps=U8_STEPS, share=TIE_SHARE):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    frac = float((d > 0).mean())
    log(f"  {name}: max |diff| {int(d.max())} u8, differing share {frac:.6f}")
    assert got.shape == want.shape, (got.shape, want.shape)
    assert d.max() <= steps, f"{name}: {int(d.max())} u8 steps > {steps}"
    assert frac <= share, f"{name}: differing share {frac} > {share}"


def pairs(n, h, w, seed=0):
    """n synthetic (low, high) u8 pairs; distinct scenes cycle every 4."""
    from low_light_image_enhancement_tpu.data.synth import synth_batch

    k = min(n, 4)
    lows, highs = synth_batch(k, h, w, seed=seed)
    reps = -(-n // k)
    return np.tile(lows, (reps, 1, 1, 1))[:n], np.tile(highs,
                                                       (reps, 1, 1, 1))[:n]


def reference(cfg, params, imgs):
    """Plain float32 jnp graph, matmuls and convs at full f32 precision."""
    import jax

    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    with jax.default_matmul_precision("highest"):
        pipe = EnhancePipeline(cfg.replace(compute_dtype="float32"),
                               model_params=params, force_jnp=True)
        return pipe.enhance_batch(imgs)


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #

METHODS = ("retinex", "curve", "hybrid", "fcn", "decom")


def phase_enhance():
    from low_light_image_enhancement_tpu import cli
    from low_light_image_enhancement_tpu.data.synth import synth_pair
    from low_light_image_enhancement_tpu.io.codec import (
        decode_image,
        encode_image,
    )

    low, _ = synth_pair(0, 400, 600)
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "dark.png")
        encode_image(low, src)
        for m in METHODS:
            dst = os.path.join(d, f"{m}.png")
            t0 = time.perf_counter()
            rc = cli.main(["enhance", src, dst, "--method", m])
            out = decode_image(dst)
            log(f"  llie enhance --method {m}: rc {rc}, {out.shape}, mean "
                f"{out.mean():.1f} (input {low.mean():.1f}), "
                f"{time.perf_counter() - t0:.1f} s")
            assert rc == 0 and out.shape == low.shape
            assert out.mean() > low.mean() + 5, "output is not brighter"


def phase_parity():
    from low_light_image_enhancement_tpu import PipelineConfig
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    cfg = PipelineConfig()
    kern = EnhancePipeline(cfg)
    assert kern._use_kernel, "the fused kernel is not on"
    for b, h, w in ((48, 400, 600), (8, 1080, 1920), (1, 2160, 3840),
                    (2, 33, 47)):
        lows, highs = pairs(b, h, w, seed=1)
        got, want = kern.enhance_batch(lows), reference(cfg, None, lows)
        compare(f"retinex kernel {w}x{h} b{b}", got, want)
        gap = abs(psnr_db(got, highs) - psnr_db(want, highs))
        log(f"    PSNR vs GT: kernel {psnr_db(got, highs):.4f} dB, "
            f"reference {psnr_db(want, highs):.4f} dB, gap {gap:.4f}")
        assert gap <= PSNR_GAP_DB
    lows, highs = pairs(8, 400, 600, seed=2)
    for m in METHODS[1:]:
        base = PipelineConfig(method=m)
        f32 = EnhancePipeline(base.replace(compute_dtype="float32"))
        want = reference(base, f32.model_params, lows)
        compare(f"{m} float32", f32.enhance_batch(lows), want)
        bf16 = EnhancePipeline(base, model_params=f32.model_params)
        got = bf16.enhance_batch(lows)
        p_got, p_ref = psnr_db(got, highs), psnr_db(want, highs)
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        log(f"  {m} bfloat16: PSNR vs GT {p_got:.4f} dB, reference "
            f"{p_ref:.4f} dB, gap {abs(p_got - p_ref):.4f}; max |diff| "
            f"{int(d.max())} u8, differing share {(d > 0).mean():.4f}")
        assert abs(p_got - p_ref) <= PSNR_GAP_DB


def phase_serve():
    import http.client
    from concurrent.futures import ThreadPoolExecutor

    from low_light_image_enhancement_tpu import PipelineConfig
    from low_light_image_enhancement_tpu.http_server import HttpEnhanceServer
    from low_light_image_enhancement_tpu.io.codec import (
        decode_image,
        encode_image,
    )

    small, _ = pairs(4, 400, 600, seed=3)
    big, _ = pairs(4, 1080, 1920, seed=4)
    bodies = [encode_image(im, format="PNG") for im in list(small) + list(big)]
    shapes = [im.shape for im in list(small) + list(big)]
    srv = HttpEnhanceServer(PipelineConfig(), host="127.0.0.1", port=0,
                            max_batch=8, max_delay_ms=20.0).start()
    try:
        def request(method, path, body=None):
            conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)
            try:
                conn.request(method, path, body=body,
                             headers={"Content-Type": "image/png"}
                             if body else {})
                r = conn.getresponse()
                return r.status, r.read()
            finally:
                conn.close()

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as ex:
            res = list(ex.map(lambda b: request("POST", "/enhance", b),
                              bodies))
        log(f"  {len(bodies)} concurrent POST /enhance in "
            f"{time.perf_counter() - t0:.1f} s (compiles included)")
        for (status, body), shape in zip(res, shapes):
            assert status == 200, (status, body[:200])
            assert decode_image(body).shape == shape
        status, body = request("GET", "/healthz")
        assert status == 200 and body.strip() == b"ok", (status, body)
        status, body = request("GET", "/stats")
        stats = json.loads(body)
        log(f"  /healthz ok; /stats {json.dumps(stats)}")
        assert status == 200
    finally:
        srv.close()


def phase_video():
    from low_light_image_enhancement_tpu import PipelineConfig
    from low_light_image_enhancement_tpu.video import (
        MultiStreamVideoEnhancer,
        VideoEnhancer,
    )

    frames, _ = pairs(8, 1080, 1920, seed=5)
    for m in ("retinex", "hybrid"):
        ve = VideoEnhancer(PipelineConfig(method=m), alpha=0.3)
        t0 = time.perf_counter()
        outs = [ve.process(f) for f in frames]
        log(f"  VideoEnhancer {m}: 8 frames 1080p in "
            f"{time.perf_counter() - t0:.1f} s (compile included)")
        assert all(o.shape == frames[0].shape for o in outs)
        assert np.mean(outs) > np.mean(frames) + 5
    mv = MultiStreamVideoEnhancer(4, PipelineConfig(), alpha=0.3)
    for t in range(3):
        out = mv.process(frames[t:t + 4])
        assert out.shape == (4,) + frames[0].shape
    log(f"  MultiStreamVideoEnhancer 4 streams: 3 steps, carry "
        f"{mv.carry_bytes} bytes")


def phase_raw():
    from low_light_image_enhancement_tpu import PipelineConfig
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    lows, _ = pairs(4, 400, 600, seed=6)
    x = lows.astype(np.float32) / 255.0
    raw = np.empty(lows.shape[:3], np.float32)  # RGGB: each site's channel
    raw[:, 0::2, 0::2] = x[:, 0::2, 0::2, 0]
    raw[:, 0::2, 1::2] = x[:, 0::2, 1::2, 1]
    raw[:, 1::2, 0::2] = x[:, 1::2, 0::2, 1]
    raw[:, 1::2, 1::2] = x[:, 1::2, 1::2, 2]
    mosaics = np.round(raw * 65535).astype(np.uint16)
    kern = EnhancePipeline(PipelineConfig())
    got = np.stack([kern.enhance_raw(m) for m in mosaics])
    want = EnhancePipeline(PipelineConfig(), force_jnp=True
                           ).enhance_raw_batch(mosaics)
    assert got.shape == lows.shape
    compare("enhance_raw 600x400 kernel vs plain", got, want)


def phase_train():
    import jax

    from low_light_image_enhancement_tpu.data.synth_device import (
        synth_pair_batch,
    )
    from low_light_image_enhancement_tpu.train import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    tcfg = TrainConfig(batch_size=64, crop=512)
    params, opt_state = init_train_state(tcfg)
    step = make_train_step(tcfg)
    low, _ = synth_pair_batch(jax.random.PRNGKey(0), 64, 512, 512)
    t0 = time.perf_counter()
    params, opt_state, m = step(params, opt_state, low)
    losses = [float(m["loss"])]
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, low)
        jax.block_until_ready(params)
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    log(f"  curve trainer 512x512 b64: compile {compile_s:.1f} s "
        f"(first step included), median step {np.median(times):.4f} s, "
        f"losses {[round(v, 4) for v in losses]}")
    assert all(np.isfinite(losses)), losses


def phase_four_cards():
    import jax
    import jax.numpy as jnp

    from low_light_image_enhancement_tpu import PipelineConfig
    from low_light_image_enhancement_tpu.parallel import (
        SpatialShardedVideoEnhancer,
        make_mesh,
    )
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline
    from low_light_image_enhancement_tpu.train import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )
    from low_light_image_enhancement_tpu.video import VideoEnhancer

    lows, _ = pairs(48, 400, 600, seed=7)
    one = EnhancePipeline(PipelineConfig())
    dp = EnhancePipeline(PipelineConfig(data_shards=4))
    a, b = one.enhance_batch(lows), dp.enhance_batch(lows)
    log(f"  data_shards=4 600x400 b48: identical {np.array_equal(a, b)}")
    # the batch-sharded program has no collectives: bit-identical
    np.testing.assert_array_equal(a, b)

    frame4k, _ = pairs(4, 2160, 3840, seed=8)
    for m in ("retinex", "hybrid"):
        single = EnhancePipeline(PipelineConfig(method=m))
        sharded = EnhancePipeline(PipelineConfig(method=m, spatial_shards=4),
                                  model_params=single.model_params)
        compare(f"spatial_shards=4 {m} 4K", sharded.enhance_batch(frame4k[:1]),
                single.enhance_batch(frame4k[:1]))

    mesh = make_mesh(n_data=1, n_spatial=4)
    sve = SpatialShardedVideoEnhancer(mesh, PipelineConfig(), alpha=0.3)
    ve = VideoEnhancer(PipelineConfig(), alpha=0.3)
    for i, f in enumerate(frame4k):
        compare(f"SpatialShardedVideoEnhancer 4K frame {i}", sve.process(f),
                ve.process(f))

    # DP training: the batch shards over four cards and XLA all-reduces
    # the gradients, which sums in another order than one card does; the
    # losses agree to float32 reduction-order noise, compounded over steps.
    tcfg = TrainConfig(batch_size=64, crop=256)
    x, _ = pairs(64, 256, 256, seed=9)
    batch = jnp.asarray(np.moveaxis(x, -1, 1).astype(np.float32) / 255.0)
    runs = {}
    for name, mesh_ in (("1 card", None),
                        ("4 cards", make_mesh(n_data=4, n_spatial=1))):
        params, opt_state = init_train_state(tcfg)
        step = make_train_step(tcfg, mesh_)
        losses = []
        for _ in range(3):
            params, opt_state, m = step(params, opt_state, batch)
            losses.append(float(m["loss"]))
        runs[name] = losses
    log(f"  DP curve train losses: {runs}")
    np.testing.assert_allclose(runs["4 cards"], runs["1 card"], rtol=1e-3)


# --------------------------------------------------------------------- #


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, found {devs}", file=sys.stderr)
        return 2
    if len(devs) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs, "
              f"found {len(devs)}", file=sys.stderr)
        return 2
    log(card_line())
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    sys.path.insert(0, REPO)
    from low_light_image_enhancement_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    log(f"compile cache: {enable_compile_cache()}")
    phases = ([("four_cards", phase_four_cards)] if args.cards == 4 else
              [("enhance", phase_enhance), ("parity", phase_parity),
               ("serve", phase_serve), ("video", phase_video),
               ("raw", phase_raw), ("train", phase_train)])
    failed = []
    for name, fn in phases:
        log(f"[{name}]")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # every phase runs; any failure fails the run
            traceback.print_exc()
            failed.append(name)
            log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
            continue
        log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
