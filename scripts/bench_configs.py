#!/usr/bin/env python
"""Per-config benchmarks for the five BASELINE.json workloads (lines 6-12).

Prints one JSON line per config (JSONL on stdout), each naming the devices
it ran on. The sharded config runs over every device present and records
the count. A config that fails stops the run with a non-zero exit.

Usage: python scripts/bench_configs.py [--configs 1 2 3 4 5] [--quick]
       [--cpu-mesh]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def _sync(x):
    jax.block_until_ready(x)


def _rate(step_fn, x0, batch, iters=12, repeats=3):
    """Median over ``repeats`` of batch * iters / wall time, each window
    ``iters`` dispatches on the same input closed by one sync."""
    _sync(step_fn(x0))
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            y = step_fn(x0)
        _sync(y)
        rates.append(batch * iters / (time.perf_counter() - t0))
    return float(np.median(rates))


def config1_single_cpu(quick: bool) -> dict:
    """Single LOL 600x400 image: Retinex + gamma on CPU JAX, parity vs the
    reference (pure-jnp) path. BASELINE.json:7."""
    from low_light_image_enhancement_tpu.config import PRESETS
    from low_light_image_enhancement_tpu.data.synth import synth_pair
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    low, _ = synth_pair(0, 400, 600)
    pipe = EnhancePipeline(PRESETS["config1_single_cpu"], force_jnp=True)
    out1 = pipe.enhance(low)  # compile
    t0 = time.perf_counter()
    n = 3 if quick else 10
    for _ in range(n):
        out1 = pipe.enhance(low)
    dt = (time.perf_counter() - t0) / n
    # parity: this IS the reference path; re-run through the default pipeline
    ref = EnhancePipeline(PRESETS["config1_single_cpu"]).enhance(low)
    return {
        "config": 1,
        "sec_per_image": round(dt, 4),
        "parity_max_abs_u8": int(
            np.abs(out1.astype(int) - ref.astype(int)).max()
        ),
    }


def config2_lol_eval(quick: bool) -> dict:
    """LOL eval-15 batched inference with fused decode->enhance->encode on
    one core. BASELINE.json:8."""
    import io as _io

    from low_light_image_enhancement_tpu.data.lol import LOLDataset
    from low_light_image_enhancement_tpu.io.codec import decode_image, encode_image
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    ds = LOLDataset(split="eval15")
    lows, _ = ds.as_batch(4 if quick else 15)
    blobs = [encode_image(im, format="PNG") for im in lows]
    pipe = EnhancePipeline()
    pipe.enhance_batch(lows[:1])  # compile

    t0 = time.perf_counter()
    decoded = np.stack([decode_image(b) for b in blobs])
    out = pipe.enhance_batch(decoded)
    encoded = [encode_image(im, format="PNG") for im in out]
    dt = time.perf_counter() - t0
    return {
        "config": 2,
        "n_images": len(blobs),
        "images_per_sec_e2e": round(len(blobs) / dt, 2),
        "bytes_out": sum(len(b) for b in encoded),
    }


def config3_curve_cnn(quick: bool) -> dict:
    """Zero-DCE-style curve CNN at 512x512 batch-64 on one device: training
    step rate, bf16 and f32. BASELINE.json:9."""
    from low_light_image_enhancement_tpu.train import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    import jax.random as jrandom

    bs = 8 if quick else 64
    crop = 128 if quick else 512
    tcfg = TrainConfig(batch_size=bs, crop=crop)
    params, opt_state = init_train_state(tcfg)
    step = make_train_step(tcfg)
    # generate the batch on device
    batch = jax.jit(
        lambda k: jrandom.uniform(k, (bs, 3, crop, crop), jnp.float32)
    )(jrandom.PRNGKey(0))

    print(f"[config3] compiling {crop}x{crop} b{bs} train step...",
          file=sys.stderr, flush=True)
    params, opt_state, m = step(params, opt_state, batch)  # compile
    _sync(m["loss"])
    print("[config3] compiled; timing", file=sys.stderr, flush=True)
    n = 3 if quick else 10
    t0 = time.perf_counter()
    for _ in range(n):
        params, opt_state, m = step(params, opt_state, batch)
    _sync(m["loss"])
    dt = (time.perf_counter() - t0) / n
    out = {
        "config": 3,
        "batch": bs,
        "crop": crop,
        "train_steps_per_sec": round(1.0 / dt, 3),
        "train_images_per_sec": round(bs / dt, 1),
        "loss": round(float(m["loss"]), 4),
    }
    # Per-image FLOPs/bytes of fwd+bwd+update and the rates they imply,
    # and an f32-compute arm beside the bf16 default.
    from low_light_image_enhancement_tpu.utils.roofline import (
        achieved,
        train_step_cost,
    )

    out.update(achieved(train_step_cost(
        tcfg.features, tcfg.n_iter, crop, remat=tcfg.remat,
        compute_dtype=tcfg.compute_dtype), bs / dt))
    import dataclasses as _dc

    tcfg32 = _dc.replace(tcfg, compute_dtype="float32")
    step32 = make_train_step(tcfg32)
    params32, opt32 = init_train_state(tcfg32)
    params32, opt32, m32 = step32(params32, opt32, batch)  # compile
    _sync(m32["loss"])
    t0 = time.perf_counter()
    for _ in range(n):
        params32, opt32, m32 = step32(params32, opt32, batch)
    _sync(m32["loss"])
    dt32 = (time.perf_counter() - t0) / n
    out["train_images_per_sec_f32"] = round(bs / dt32, 1)
    out["train_f32_loss"] = round(float(m32["loss"]), 4)
    for k, v in achieved(train_step_cost(
            tcfg.features, tcfg.n_iter, crop, remat=tcfg.remat,
            compute_dtype="float32"), bs / dt32).items():
        out[k + "_f32"] = v
    return out


def config4_1080p_stream(quick: bool) -> dict:
    """1080p video-frame streaming enhancement with double-buffered
    host->device prefetch. BASELINE.json:10."""
    from low_light_image_enhancement_tpu.io.prefetch import PrefetchQueue
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    h, w, n_frames = 1080, 1920, (8 if quick else 32)
    rng = np.random.default_rng(0)
    frame = (rng.random((h, w, 3)) * 60).astype(np.uint8)  # dark 1080p
    pipe = EnhancePipeline()
    _sync(pipe.enhance_batch_device(jnp.asarray(frame[None])))  # compile

    def frames():
        for i in range(n_frames):
            # host-side work per frame (copy stands in for decode)
            yield np.ascontiguousarray(frame)[None]

    t0 = time.perf_counter()
    out = None
    for batch in PrefetchQueue(frames(), depth=2):
        out = pipe.enhance_batch_device(batch)
    _sync(out)
    dt = time.perf_counter() - t0
    from low_light_image_enhancement_tpu.utils.roofline import (
        achieved,
        pipeline_cost,
    )

    out = {
        "config": 4,
        "frames": n_frames,
        "fps_1080p": round(n_frames / dt, 2),
    }
    out.update(achieved(pipeline_cost(pipe.config, h, w), n_frames / dt))

    # Staging A/B: the same stream through enhance_stream with device-side
    # transposes (hwc) vs host-staged planar frames. Both fetch results to
    # host (e2e fps).
    for staging in ("hwc", "planar"):
        def gen():
            for _ in range(n_frames):
                yield frame[None]

        # warm up compile outside the timed window
        next(iter(pipe.enhance_stream(iter([frame[None]]), staging=staging)))
        t0 = time.perf_counter()
        n_out = 0
        for res in pipe.enhance_stream(gen(), staging=staging, workers=2):
            n_out += 1
        dt_s = time.perf_counter() - t0
        out[f"fps_1080p_e2e_{staging}"] = round(n_out / dt_s, 2)
    return out



def _video_chain(step, dev, k):
    """k chained stateful video steps in ONE jitted program (lax.scan with
    a frame-checksum carry so the per-step output stays live): one host
    dispatch per chain, so the short/long difference is device time.

    The frame VARIES per step (alternating between two pre-staged frames
    by index): with a constant frame, per-frame work (the illumination and
    blur) is loop-invariant and XLA hoists it out of the scan. Real video
    never repeats frames."""
    import jax as _jax

    @_jax.jit
    def run(state):
        if jnp.issubdtype(dev.dtype, jnp.integer):
            alt = jnp.bitwise_xor(dev, jnp.asarray(1, dev.dtype))
        else:  # f32 frames (the sharded video chain): one u8-step nudge
            alt = jnp.clip(dev + jnp.asarray(1.0 / 255.0, dev.dtype),
                           0.0, 1.0)
        frames = jnp.stack([dev, alt])

        def body(carry, i):
            st, acc = carry
            st, y = step(st, frames[i])
            return (st, acc + jnp.mean(y.astype(jnp.float32))), None

        xs = jnp.arange(k, dtype=jnp.int32) % 2
        (st, acc), _ = _jax.lax.scan(body, (state, jnp.float32(0)), xs)
        return st, acc

    return run


def config7_video_stateful(quick: bool) -> dict:
    """Temporally-stable video (VideoEnhancer) device rate at 1080p: the
    stateful step (EMA carry feeding forward) chained on-device, one sync
    at the end. Reported per method; the e2e number is config 4's."""
    from low_light_image_enhancement_tpu.config import PipelineConfig
    from low_light_image_enhancement_tpu.video import VideoEnhancer

    h, w = (540, 960) if quick else (1080, 1920)
    n = 8 if quick else 30
    rng = np.random.default_rng(0)
    frame = (rng.random((h, w, 3)) * 60).astype(np.uint8)
    out = {"config": 7, "h": h, "w": w}
    for label, cfg in (
        ("retinex", PipelineConfig()),
        ("curve_ds4", PipelineConfig(method="curve", curve_downsample=4)),
        ("hybrid_ds4", PipelineConfig(method="hybrid", curve_downsample=4)),
    ):
        ve = VideoEnhancer(cfg, alpha=0.3)
        ve.process(frame)  # compile + init state
        dev = jnp.asarray(frame)
        state = ve._state
        runs = {k: _video_chain(ve._step, dev, k) for k in (2, 2 + n)}

        def chain(k, state):
            t0 = time.perf_counter()
            st, acc = runs[k](state)
            _ = float(acc)
            return time.perf_counter() - t0, st

        chain(2, state)
        chain(2 + n, state)
        ts, _ = chain(2, state)
        tl, _ = chain(2 + n, state)
        out[f"video_fps_{label}"] = n / (tl - ts)

    # Multi-stream: one batched step carries S streams (reported as
    # frames/sec SUMMED over streams).
    from low_light_image_enhancement_tpu.video import MultiStreamVideoEnhancer

    s = 8
    frames = np.stack([frame] * s)
    for label, cfg in (
        ("curve_ds4", PipelineConfig(method="curve", curve_downsample=4)),
        ("hybrid_ds4", PipelineConfig(method="hybrid", curve_downsample=4)),
    ):
        mv = MultiStreamVideoEnhancer(s, cfg, alpha=0.3)
        mv.process(frames)  # compile + init state
        dev = jnp.asarray(frames)
        state = mv._state
        runs_s = {k: _video_chain(mv._step, dev, k) for k in (2, 2 + n)}

        def chain_s(k, state):
            t0 = time.perf_counter()
            st, acc = runs_s[k](state)
            _ = float(acc)
            return time.perf_counter() - t0, st

        chain_s(2, state)
        chain_s(2 + n, state)
        ts, _ = chain_s(2, state)
        tl, _ = chain_s(2 + n, state)
        out[f"video_fps_{label}_x{s}streams"] = s * n / (tl - ts)
    return out


def config5_4k_sharded(quick: bool) -> dict:
    """4K pipeline sharded spatially with per-shard denoise over however
    many devices exist. BASELINE.json:11."""
    from low_light_image_enhancement_tpu import backend
    from low_light_image_enhancement_tpu.config import PipelineConfig
    from low_light_image_enhancement_tpu.parallel import (
        enhance_spatial_sharded,
        make_mesh,
    )

    n_dev = len(jax.devices())
    mesh = make_mesh(n_data=1, n_spatial=n_dev)
    cfg = PipelineConfig()
    h, w = (1080, 1920) if quick else (2160, 3840)
    use_kernel = backend.use_kernel(cfg)
    rng = np.random.default_rng(0)
    # u8 end-to-end: u8 halos, per-shard kernel or plain graph
    x = jnp.asarray((rng.random((1, 3, h, w)) * 76).astype(np.uint8))
    fn = jax.jit(
        lambda v: enhance_spatial_sharded(v, cfg, mesh, use_kernel=use_kernel)
    )
    rate = _rate(fn, x, 1, iters=2 if quick else 20, repeats=5)
    out = {
        "config": 5,
        "n_devices": n_dev,
        "resolution": f"{h}x{w}",
        "dtype": str(x.dtype),
        "frames_per_sec_4k": rate,
    }
    if n_dev >= 4:
        # combined data x spatial sharding (VERDICT r1 item 7: n_data > 1):
        # 2 frames in flight, each spatially split over n_dev/2 devices
        mesh2 = make_mesh(n_data=2, n_spatial=n_dev // 2)
        x2 = jnp.concatenate([x, x], axis=0)
        fn2 = jax.jit(
            lambda v: enhance_spatial_sharded(v, cfg, mesh2,
                                              use_kernel=use_kernel)
        )
        out["frames_per_sec_4k_n_data2"] = _rate(fn2, x2, 2, iters=4)

    # Sharded stateful VIDEO at 4K (config 5 x config 4): the
    # SpatialShardedVideoEnhancer step — per-shard EMA carry + per-frame
    # halo exchange — chained on the same mesh.
    from low_light_image_enhancement_tpu.parallel import (
        SpatialShardedVideoEnhancer,
    )

    frame_hwc = np.asarray(jnp.moveaxis(x[0], 0, -1))
    for label in ("",):
        sve = SpatialShardedVideoEnhancer(mesh, cfg, alpha=0.3)
        sve.process(frame_hwc)  # compile + init state
        dev = jnp.asarray(frame_hwc)
        state = sve._state
        runs_v = {k: _video_chain(sve._step, dev, k)
                  for k in (4, 4 + (4 if quick else 16))}

        def chain_v(k, state):
            t0 = time.perf_counter()
            st, acc = runs_v[k](state)
            _ = float(acc)
            return time.perf_counter() - t0, st

        n_v = 4 if quick else 16
        chain_v(4, state)
        chain_v(4 + n_v, state)  # steady-state warmup (layout/alloc settle)
        rates = []
        for _ in range(5):
            ts, _ = chain_v(4, state)
            tl, _ = chain_v(4 + n_v, state)
            rates.append(n_v / (tl - ts))
        out[f"video_fps_4k_sharded{label}"] = float(np.median(rates))
    return out


def config6_ingest(quick: bool) -> dict:
    """Host-ingest (PNG-decode) throughput: the host-side ceiling that the
    prefetch queue must hide to keep the device fed (SURVEY.md §7 hard part
    (d); VERDICT r1 item 3). Measures decode-only rate at 600x400 for
    worker counts 1/2/4/8, plus an overlap check: decode feeding the device
    pipeline through PrefetchQueue vs the decode-only rate."""
    import multiprocessing

    from low_light_image_enhancement_tpu.data.synth import synth_batch
    from low_light_image_enhancement_tpu.io.codec import (
        decode_image,
        encode_image,
    )
    from low_light_image_enhancement_tpu.io.prefetch import PrefetchQueue
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    n = 32 if quick else 128
    lows, _ = synth_batch(8, 400, 600)
    blobs = [
        encode_image(lows[i % 8], format="PNG")
        for i in range(n)
    ]

    decode_rate = {}
    for workers in (1, 2, 4, 8):
        t0 = time.perf_counter()
        got = 0
        with PrefetchQueue(iter(blobs), depth=4, transform=decode_image,
                           device_put=False, workers=workers) as q:
            for _ in q:
                got += 1
        assert got == n
        decode_rate[str(workers)] = round(n / (time.perf_counter() - t0), 1)

    # overlap: decode -> device enhance through the queue; if prefetch hides
    # decode behind device compute (or vice versa), e2e ~= min path's rate.
    # Dispatch in batches of 8, as a serving batcher would.
    group = 8
    pipe = EnhancePipeline()
    _sync(pipe.enhance_batch_device(jnp.asarray(lows[:group])))  # compile
    t0 = time.perf_counter()
    out, pend = None, []
    with PrefetchQueue(iter(blobs), depth=2 * group,
                       transform=decode_image, workers=1) as q:
        for img in q:
            pend.append(img)
            if len(pend) == group:
                out = pipe.enhance_batch_device(np.stack(pend))
                pend.clear()
    if pend:
        out = pipe.enhance_batch_device(np.stack(pend))
    _sync(out)
    e2e = n / (time.perf_counter() - t0)
    return {
        "config": "ingest",
        "n_images": n,
        "host_cores": multiprocessing.cpu_count(),
        "decode_images_per_sec": decode_rate,
        "decode_plus_device_images_per_sec": round(e2e, 1),
    }


def _mosaic_from_rgb(rgb_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) u8 -> (H, W) f32 RGGB mosaic (keep each Bayer site's own
    channel — the ideal-sensor inverse of a demosaic)."""
    h, w, _ = rgb_u8.shape
    x = rgb_u8.astype(np.float32) / 255.0
    raw = np.empty((h, w), np.float32)
    raw[0::2, 0::2] = x[0::2, 0::2, 0]
    raw[0::2, 1::2] = x[0::2, 1::2, 1]
    raw[1::2, 0::2] = x[1::2, 0::2, 1]
    raw[1::2, 1::2] = x[1::2, 1::2, 2]
    return raw


def config8_raw_ingest(quick: bool) -> dict:
    """RAW (Bayer) ingest: parity of the single-program path vs the
    explicit two-stage composition, the one-dispatch-vs-two A/B, a
    device-chained single-program rate, and a synthetic-mosaic quality row
    (PSNR/SSIM vs the RGB GT the mosaics were sampled from)."""
    from low_light_image_enhancement_tpu.config import PipelineConfig
    from low_light_image_enhancement_tpu.data.synth import synth_batch
    from low_light_image_enhancement_tpu.eval.metrics import psnr, ssim
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    b = 8 if quick else 48
    h, w = (128, 192) if quick else (400, 600)
    lows, highs = synth_batch(min(b, 8), h, w)
    reps = -(-b // lows.shape[0])
    lows = np.tile(lows, (reps, 1, 1, 1))[:b]
    highs = np.tile(highs, (reps, 1, 1, 1))[:b]
    raws = np.stack([_mosaic_from_rgb(im) for im in lows])

    pipe = EnhancePipeline(PipelineConfig())
    out = {"config": 8, "h": h, "w": w, "batch": b}

    # 1) parity: fused one-program path vs explicit two-stage
    # (ISP program -> standard enhance) — must be bit-exact (the same
    # floats flow through both).
    fused = pipe.enhance_raw_batch(raws)
    from low_light_image_enhancement_tpu.ops.isp import DEFAULT_CCM

    ccm_key = tuple(tuple(float(v) for v in row)
                    for row in np.asarray(DEFAULT_CCM))
    srgb = np.asarray(
        pipe._compiled_isp(b, h, w, None, ccm_key, 1.0 / 2.2)(
            jnp.asarray(raws))
    )
    staged = pipe.enhance_batch(srgb)
    out["parity_fused_vs_two_stage_max_u8"] = int(
        np.abs(fused.astype(int) - staged.astype(int)).max()
    )

    # 2) quality: mosaic -> fused RAW enhance vs the RGB ground truth the
    # synthetic pair was built from (the RGB-route numbers are the eval
    # runner's; this row isolates what the Bayer round-trip costs).
    fe = jnp.asarray(fused, jnp.float32) / 255.0
    ge = jnp.asarray(highs, jnp.float32) / 255.0
    fe_p = jnp.transpose(fe, (0, 3, 1, 2))
    ge_p = jnp.transpose(ge, (0, 3, 1, 2))
    out["raw_psnr_db"] = round(float(jnp.mean(psnr(fe_p, ge_p))), 2)
    out["raw_ssim"] = round(float(jnp.mean(ssim(fe_p, ge_p))), 3)

    # 3) one-dispatch-vs-two A/B (python-chained marginal rate: both arms
    # pay per-iteration dispatch, the fused arm pays it once per image
    # batch instead of twice — the claimed win of fusing the ISP into the
    # enhance program).
    dev_raws = jnp.asarray(raws)
    wb_key = None
    fused_fn = pipe._compiled_raw(b, h, w, wb_key, ccm_key, 1.0 / 2.2)
    isp_fn = pipe._compiled_isp(b, h, w, wb_key, ccm_key, 1.0 / 2.2)
    enh_fn = pipe._compiled(b, h, w)

    def fused_step(x):
        return fused_fn(x, pipe.model_params)

    def staged_step(x):
        return enh_fn(isp_fn(x), pipe.model_params)

    _sync(fused_step(dev_raws))
    _sync(staged_step(dev_raws))
    n_s, n_l = (2, 8) if quick else (3, 12)

    def py_rate(step):
        def chain(n):
            t0 = time.perf_counter()
            o = None
            for _ in range(n):
                o = step(dev_raws)
            _sync(o)
            return time.perf_counter() - t0

        chain(n_s)
        rates = []
        for _ in range(3):
            t_s, t_l = chain(n_s), chain(n_l)
            rates.append(b * (n_l - n_s) / (t_l - t_s) if t_l > t_s
                         else b * n_l / t_l)
        return float(np.median(rates))

    out["raw_fused_images_per_sec_pychain"] = round(py_rate(fused_step), 1)
    out["raw_two_dispatch_images_per_sec_pychain"] = round(
        py_rate(staged_step), 1)

    # 4) device-chained fused rate: serialize iterations through a data
    # dependency on the previous output's max (adds one reduce per
    # iteration).
    from low_light_image_enhancement_tpu.pipeline import (
        _enhance_u8_batch,
        _isp_u8_hwc,
    )
    import functools

    body_enh = functools.partial(
        _enhance_u8_batch, cfg=pipe.config, use_kernel=pipe._use_kernel,
        interpret=pipe._interpret,
    )
    params = pipe.model_params

    def dev_chain(k):
        @jax.jit
        def run(raws_in):
            def step(c, _):
                # min(c, 0) is 0 at runtime (c = a u8 max, >= 0) but not
                # foldable statically, so the scan stays serialized on the
                # previous iteration's output
                u8 = _isp_u8_hwc(raws_in + jnp.minimum(c, 0.0) * 1e-6,
                                 wb_key, ccm_key, 1.0 / 2.2)
                o = body_enh(u8, params)
                return jnp.max(o).astype(jnp.float32), None

            c, _ = jax.lax.scan(step, jnp.float32(0), None, length=k)
            return c

        return run

    runs = {k: dev_chain(k) for k in (n_s, n_l)}
    for k in (n_s, n_l):
        _ = float(runs[k](dev_raws))
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        _ = float(runs[n_s](dev_raws))
        t_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _ = float(runs[n_l](dev_raws))
        t_l = time.perf_counter() - t0
        rates.append(b * (n_l - n_s) / (t_l - t_s) if t_l > t_s
                     else b * n_l / t_l)
    out["raw_fused_images_per_sec_devchain"] = round(
        float(np.median(rates)), 1)
    return out


CONFIGS = {
    1: config1_single_cpu,
    2: config2_lol_eval,
    3: config3_curve_cnn,
    4: config4_1080p_stream,
    7: config7_video_stateful,
    5: config5_4k_sharded,
    6: config6_ingest,
    8: config8_raw_ingest,
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, nargs="*",
                    default=[1, 2, 3, 4, 7, 5, 6, 8])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu-mesh", action="store_true",
                    help="run on the CPU backend with 8 virtual devices "
                         "(rehearsal of the sharded configs; set through "
                         "jax.config before the backend starts)")
    args = ap.parse_args()
    if args.cpu_mesh:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    devs = jax.devices()
    for c in args.configs:
        res = CONFIGS[c](args.quick)
        res["device"] = {"platform": devs[0].platform,
                         "kind": devs[0].device_kind, "count": len(devs)}
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
