"""Command-line interface: ``llie enhance | eval | bench | train | serve |
video``.

Spec: BASELINE.json north_star public API ("enhance(image)->image, dataset
eval scripts") exposed as a CLI (SURVEY.md L6); ``serve`` fronts the
micro-batching EnhanceServer over HTTP (http_server.py) and ``video`` runs
the temporally-stable frame-sequence path (video.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

from low_light_image_enhancement_tpu.config import (
    CONV_IMPLS,
    PRESETS,
    PipelineConfig,
)


def _add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="named benchmark config (BASELINE.json 1-5)")
    p.add_argument(
        "--method",
        choices=["retinex", "curve", "hybrid", "fcn", "decom"],
        default=None,
    )
    p.add_argument("--gamma", type=float, default=None)
    p.add_argument("--decom-gamma", type=float, default=None,
                   help="decom method's illumination exponent")
    p.add_argument("--denoise-strength", type=float, default=None)
    p.add_argument("--denoise-taps", choices=["sep", "full", "guided"],
                   default=None,
                   help="sep (default, +37%% throughput), full 3x3, or the "
                        "guided-filter tail (quality lever)")
    p.add_argument("--denoise-guide", choices=["luma", "perchannel"],
                   default=None)
    p.add_argument("--guided-radius", type=int, default=None,
                   help="guided tail box radius (with --denoise-taps guided)")
    p.add_argument("--guided-eps", type=float, default=None,
                   help="guided tail edge/flat threshold")
    p.add_argument("--curve-downsample", type=int, choices=[1, 2, 4, 8],
                   default=None, help="estimate curve maps at 1/N res")
    p.add_argument("--conv-impl", choices=list(CONV_IMPLS), default=None,
                   help="learned-model conv lowering (auto: XLA's own)")
    p.add_argument("--data-shards", type=int, default=None,
                   help="shard batches over N devices (DP inference/serving)")
    p.add_argument("--no-pallas", action="store_true",
                   help="run the plain jnp graph instead of the fused "
                        "retinex kernel")
    p.add_argument("--weights", default=None,
                   help="model weights: an .npz path or a shipped name "
                        "(zeroref, curve, hybrid, fcn, decom, plus the "
                        "guided-in-loss round-5 sets hybrid_guided/"
                        "curve_guided/fcn_guided/decom_relit[_guided] — "
                        "models.weights.NAMED); default: the method's "
                        "shipped weights, or the preset's weights_name")


def _build_config(args) -> PipelineConfig:
    cfg = PRESETS[args.preset] if args.preset else PipelineConfig()
    over = {}
    if args.method is not None:
        over["method"] = args.method
    if args.gamma is not None:
        over["gamma"] = args.gamma
    if getattr(args, "denoise_strength", None) is not None:
        over["denoise_strength"] = args.denoise_strength
    for name in ("decom_gamma", "denoise_taps", "denoise_guide",
                 "guided_radius", "guided_eps",
                 "curve_downsample", "conv_impl", "data_shards"):
        v = getattr(args, name, None)
        if v is not None:
            over[name] = v
    if args.no_pallas:
        over["use_pallas"] = False
    return cfg.replace(**over) if over else cfg


def _model_params(args):
    if getattr(args, "weights", None) is None:
        return None
    from low_light_image_enhancement_tpu.models.weights import resolve_weights

    return resolve_weights(args.weights)


def _load_raw_mosaic(path: str):
    """Load a (H, W) Bayer mosaic: .npy (u8/u16/float, or non-negative
    16-bit-range int16/int32 — common RAW container dtypes, converted to
    u16), a single-channel 8/16-bit PNG (``io.codec.decode_png``), or
    another single-channel image file such as PGM (through Pillow)."""
    import numpy as np

    if path.endswith(".npy"):
        arr = np.load(path)
        if np.issubdtype(arr.dtype, np.signedinteger):
            # int16/int32 containers hold u16 sensor DNs; convert when the
            # values fit, reject otherwise — letting them fall through to
            # enhance_raw's float branch would clip DNs to [0, 1] and
            # produce a saturated all-white result (ADVICE r4, medium).
            if arr.size and (arr.min() < 0 or arr.max() > 65535):
                raise ValueError(
                    f"--raw .npy {path} has {arr.dtype} values outside "
                    f"[0, 65535] ({arr.min()}..{arr.max()}); convert to "
                    "uint16 (with the sensor's white level) first"
                )
            arr = arr.astype(np.uint16)
        return arr
    from low_light_image_enhancement_tpu.io.codec import (
        PNG_SIGNATURE,
        _pil,
        decode_png,
    )

    with open(path, "rb") as f:
        is_png = f.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE
    if is_png:
        arr = decode_png(path)
        if arr.ndim != 2:
            raise ValueError(
                f"--raw expects a single-channel mosaic, got shape "
                f"{arr.shape} from {path}; use a .npy, 16-bit PNG, or PGM "
                "file"
            )
        return arr
    img = _pil().open(path)
    if img.mode not in ("L", "I", "I;16"):
        raise ValueError(
            f"--raw expects a single-channel mosaic, got mode {img.mode!r} "
            f"from {path}; use a .npy, 16-bit PNG, or PGM file"
        )
    arr = np.asarray(img)
    if arr.dtype == np.int32:  # PIL mode "I" -> int32; 16-bit data in range
        arr = arr.astype(np.uint16)
    return arr


def _wb_gains_arg(s: str):
    """argparse type for --wb-gains: 'R,G,B' floats -> (r, g, b), with a
    clean parser error (not a traceback) on malformed input (ADVICE r4)."""
    parts = s.split(",")
    try:
        vals = tuple(float(g) for g in parts)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--wb-gains wants three comma-separated numbers, got {s!r}"
        )
    if len(vals) != 3:
        raise argparse.ArgumentTypeError(
            f"--wb-gains wants exactly three values (R,G,B), got "
            f"{len(vals)} in {s!r}"
        )
    return vals


def cmd_enhance(args) -> int:
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    pipe = EnhancePipeline(_build_config(args), model_params=_model_params(args))
    if args.raw:
        from low_light_image_enhancement_tpu.io.codec import encode_image

        out = pipe.enhance_raw(_load_raw_mosaic(args.input),
                               wb_gains=args.wb_gains,
                               white_level=args.white_level)
        encode_image(out, args.output)
    else:
        pipe.enhance_file(args.input, args.output)
    print(f"wrote {args.output}")
    return 0


def cmd_eval(args) -> int:
    from low_light_image_enhancement_tpu.data.lol import LOLDataset
    from low_light_image_enhancement_tpu.eval.runner import eval_lol
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    ds = LOLDataset(root=args.data_dir, split=args.split)
    pipe = EnhancePipeline(_build_config(args), model_params=_model_params(args))
    report = eval_lol(pipe, ds, max_images=args.max_images,
                      parity=not args.no_parity)
    print(json.dumps(report, indent=2))
    return 0


def cmd_bench(args) -> int:
    try:
        import bench as bench_mod  # repo-root bench.py when run from checkout
    except ImportError:  # installed package: resolve relative to the repo
        import sys as _sys
        from pathlib import Path

        _sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
        import bench as bench_mod

    res = bench_mod.bench_throughput(batch=args.batch, repeats=args.repeats,
                                     method=args.bench_method,
                                     h=args.height, w=args.width)
    print(json.dumps(res))
    return 0


def cmd_train(args) -> int:
    from low_light_image_enhancement_tpu.train import (
        TrainConfig,
        train_curve_cnn,
        train_decom,
        train_fcn,
    )
    from low_light_image_enhancement_tpu.utils.logging import JSONLLogger, get_logger

    tcfg = TrainConfig(
        batch_size=args.batch, crop=args.crop, steps=args.steps,
        learning_rate=args.lr, ema_decay=args.ema_decay,
        denoise_in_loss=args.denoise_in_loss,
        eval_every=args.eval_every, eval_patience=args.eval_patience,
    )
    if args.model == "fcn":
        tcfg = dataclasses.replace(tcfg, features=24)
    logger = get_logger()
    jsonl = JSONLLogger(args.log_file) if args.log_file else None

    def log_fn(m):
        if "eval_score" in m:
            logger.info("step %s eval_score %.4f", m.get("step"),
                        m["eval_score"])
        else:
            logger.info("step %s loss %.4f", m.get("step"),
                        m.get("loss", 0.0))
        if jsonl:
            jsonl.log(m)

    kw = dict(checkpoint_dir=args.checkpoint_dir, resume=args.resume,
              log_fn=log_fn)
    if args.data_dir is not None:
        # real (or fallback-synthetic) LOL pairs instead of the on-device
        # synthetic stream; zeroref consumes lows only. The prefetch queue
        # decodes + device_puts ahead so host decode overlaps device steps.
        from low_light_image_enhancement_tpu.data.lol import LOLDataset
        from low_light_image_enhancement_tpu.io.prefetch import PrefetchQueue

        ds = LOLDataset(root=args.data_dir, split="train")
        paired = not (args.model in ("curve", "hybrid")
                      and args.objective == "zeroref")

        def _data_factory(start_step, _ds=ds, _paired=paired):
            # resume-aware: a checkpoint restore re-creates the stream at
            # the restored step, replaying exactly what a straight run sees
            plans = _ds.train_batch_plans(
                args.batch, args.crop, paired=_paired, start_step=start_step
            )
            return PrefetchQueue(
                plans, depth=2, transform=_ds.materialize_batch,
                workers=args.decode_workers,
            )

        kw["data_factory"] = _data_factory
    if args.model in ("curve", "hybrid"):
        # --objective paired (+ --denoise-in-loss for hybrid) is the exact
        # recipe the shipped curve_cnn.npz / curve_hybrid.npz weights were
        # trained with (scripts/train_weights.py) — reachable from the CLI.
        params, _ = train_curve_cnn(
            tcfg, objective=args.objective, hybrid=args.model == "hybrid",
            **kw,
        )
    elif args.model == "decom":
        params, _ = train_decom(tcfg, **kw)
    else:
        params, _ = train_fcn(tcfg, **kw)
    if args.save_weights:
        from low_light_image_enhancement_tpu.models.weights import (
            save_params,
        )

        save_params(params, args.save_weights)
        logger.info("weights saved to %s", args.save_weights)
    return 0


def cmd_serve(args) -> int:
    from low_light_image_enhancement_tpu.http_server import HttpEnhanceServer
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline
    from low_light_image_enhancement_tpu.serving import EnhanceServer

    cfg = _build_config(args)
    pipe = EnhancePipeline(cfg, model_params=_model_params(args),
                           bucket=args.bucket)
    backend = EnhanceServer(
        cfg, pipeline=pipe, max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms, max_queue=args.max_queue,
        overflow=args.overflow,
    )
    srv = HttpEnhanceServer(cfg, host=args.host, port=args.port,
                            enhance_server=backend)
    print(f"serving on http://{srv.host}:{srv.port} "
          f"(POST /enhance, GET /healthz, GET /stats)", flush=True)

    # SIGTERM (the normal orchestrator stop signal) drains like Ctrl-C:
    # stop accepting, finish in-flight requests, then exit 0
    import signal

    def _term(_sig, _frm):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
        backend.close()
    return 0


def cmd_video(args) -> int:
    import glob
    import os

    from low_light_image_enhancement_tpu.io.codec import (
        decode_image,
        encode_image,
    )

    if getattr(args, "streams", False):
        return _cmd_video_streams(args, decode_image, encode_image)

    from low_light_image_enhancement_tpu.video import VideoEnhancer

    frames = sorted(glob.glob(args.input_glob))
    if not frames:
        print(f"no frames match {args.input_glob!r}", file=sys.stderr)
        return 1
    os.makedirs(args.output_dir, exist_ok=True)
    enh = VideoEnhancer(_build_config(args),
                        model_params=_model_params(args),
                        alpha=args.alpha)
    for path in frames:
        out = enh.process(decode_image(path))
        encode_image(out, os.path.join(args.output_dir,
                                       os.path.basename(path)))
    print(f"wrote {len(frames)} frames to {args.output_dir} "
          f"(carry {enh.carry_bytes} bytes)")
    return 0


def _cmd_video_streams(args, decode_image, encode_image) -> int:
    """--streams: the glob matches one directory per independent stream;
    frame t of every stream goes through ONE batched device step
    (MultiStreamVideoEnhancer: one batched step instead of S batch-1
    steps). Streams advance in lockstep through
    their sorted frame lists; processing stops at the shortest stream."""
    import glob
    import os

    import numpy as np

    from low_light_image_enhancement_tpu.video import (
        MultiStreamVideoEnhancer,
    )

    dirs = sorted(d for d in glob.glob(args.input_glob) if os.path.isdir(d))
    if not dirs:
        print(f"no stream directories match {args.input_glob!r}",
              file=sys.stderr)
        return 1
    per_stream = []
    for d in dirs:
        fs = sorted(
            os.path.join(d, f) for f in os.listdir(d)
            if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        if not fs:
            print(f"stream directory {d!r} has no frames", file=sys.stderr)
            return 1
        per_stream.append(fs)
    n_frames = min(len(fs) for fs in per_stream)
    if any(len(fs) != n_frames for fs in per_stream):
        shortest = dirs[min(range(len(dirs)),
                            key=lambda i: len(per_stream[i]))]
        print(f"warning: streams have unequal frame counts "
              f"({n_frames}..{max(len(fs) for fs in per_stream)}); "
              f"truncating all to the shortest, {shortest!r}",
              file=sys.stderr)
    # output dir per stream: basename of the normalized path (so trailing
    # slashes don't collapse to ''), suffixed on collision between
    # distinct parents ('site_a/cam0' + 'site_b/cam0')
    names, seen = [], {}
    for d in dirs:
        n = os.path.basename(os.path.normpath(d))
        if n in seen:
            seen[n] += 1
            n = f"{n}_{seen[n]}"
        else:
            seen[n] = 0
        names.append(n)
    enh = MultiStreamVideoEnhancer(len(dirs), _build_config(args),
                                   model_params=_model_params(args),
                                   alpha=args.alpha)
    for n in names:
        os.makedirs(os.path.join(args.output_dir, n), exist_ok=True)

    # decode batch t+1 on the prefetch producer while the device enhances
    # batch t (the batched step is the throughput win — don't stall it on
    # serial PIL decodes)
    from low_light_image_enhancement_tpu.io.prefetch import PrefetchQueue

    frame_paths = [tuple(fs[t] for fs in per_stream)
                   for t in range(n_frames)]

    def _decode_batch(paths):
        return np.stack([decode_image(p) for p in paths])

    try:
        for t, batch in enumerate(
            PrefetchQueue(frame_paths, transform=_decode_batch,
                          device_put=False)
        ):
            outs = enh.process(batch)
            for i, n in enumerate(names):
                encode_image(
                    outs[i],
                    os.path.join(args.output_dir, n,
                                 os.path.basename(per_stream[i][t])),
                )
    except ValueError as e:
        # mismatched frame sizes across streams (np.stack) or a stream
        # changing size mid-sequence (MultiStreamVideoEnhancer's guard)
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"wrote {n_frames} frames x {len(dirs)} streams to "
          f"{args.output_dir} (carry {enh.carry_bytes} bytes)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    # Every CLI process after the first loads compiled executables from the
    # persistent cache (utils.compile_cache says where it lives).
    from low_light_image_enhancement_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    parser = argparse.ArgumentParser(
        prog="llie", description="low-light image enhancement in JAX"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("enhance", help="enhance one image file")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--raw", action="store_true",
                   help="input is a RGGB Bayer mosaic (.npy, 16-bit PNG, or "
                        "PGM); runs the on-device ISP (demosaic/WB/CCM) "
                        "fused ahead of the enhancement graph")
    p.add_argument("--wb-gains", default=None, metavar="R,G,B",
                   type=_wb_gains_arg,
                   help="white-balance gains for --raw (default: per-image "
                        "gray-world)")
    p.add_argument("--white-level", type=float, default=None,
                   help="full-scale mosaic value for --raw uint16 input "
                        "(e.g. 4095 for 12-bit sensors; default 65535)")
    _add_config_args(p)
    p.set_defaults(fn=cmd_enhance)

    p = sub.add_parser("eval", help="run the LOL eval harness")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--split", default="eval15")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--no-parity", action="store_true")
    _add_config_args(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("bench", help="throughput benchmark")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--bench-method", default="retinex",
                   choices=["retinex", "curve", "hybrid", "fcn", "decom"],
                   help="pipeline method to benchmark")
    p.add_argument("--height", type=int, default=400)
    p.add_argument("--width", type=int, default=600)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "train",
        help="model training: curve/hybrid (zero-reference or paired), "
             "fcn (supervised), decom (decomposition objective)",
    )
    p.add_argument("--model", choices=["curve", "hybrid", "fcn", "decom"],
                   default="curve")
    p.add_argument("--eval-every", type=int, default=0,
                   help="curve/hybrid: score held-out synthetic SSIM every N "
                        "steps, keep the best snapshot, stop after "
                        "--eval-patience non-improving evals (0 = off)")
    p.add_argument("--eval-patience", type=int, default=3)
    p.add_argument("--denoise-in-loss", action="store_true",
                   help="paired loss compares AFTER the pipeline's denoise "
                        "tail (the shipped hybrid weights' recipe: +0.06 "
                        "SSIM — docs/PERFORMANCE.md @84fe805 denoise-in-loss section)")
    p.add_argument("--objective", choices=["zeroref", "paired"],
                   default="zeroref",
                   help="curve/hybrid objective; 'paired' is the recipe "
                        "behind the shipped weights (docs/PERFORMANCE.md @84fe805)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--crop", type=int, default=512)
    p.add_argument("--steps", type=int, default=600)  # zero-ref early stop
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--data-dir", default=None,
                   help="train on LOL pairs from this root (our485 layout; "
                        "random crop + flip augmentation, prefetch-"
                        "overlapped) instead of the on-device synthetic "
                        "stream")
    p.add_argument("--decode-workers", type=int, default=1,
                   help="decode thread pool size for --data-dir")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="track an EMA of the weights (e.g. 0.999) and "
                        "save/return the averaged weights")
    p.add_argument("--log-file", default=None)
    p.add_argument("--save-weights", default=None,
                   help="write final params to this .npz")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser(
        "serve",
        help="HTTP enhancement server (POST /enhance with JPEG/PNG bytes; "
             "micro-batching dispatcher owns the device)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 binds an ephemeral port (printed at startup)")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--max-queue", type=int, default=256,
                   help="bound on in-flight requests")
    p.add_argument("--overflow", choices=["block", "reject"],
                   default="reject",
                   help="full-server policy: HTTP 503 (reject) or "
                        "producer backpressure (block)")
    p.add_argument("--bucket", type=int, default=64,
                   help="shape-bucket granularity (bounds compile count)")
    _add_config_args(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "video",
        help="enhance an ordered frame sequence with the temporally-"
             "stable video path (EMA-smoothed illumination / curve maps)",
    )
    p.add_argument("input_glob",
                   help="glob over input frames, e.g. 'frames/*.png'; "
                        "processed in sorted order")
    p.add_argument("output_dir")
    p.add_argument("--alpha", type=float, default=0.3,
                   help="new-frame weight of the temporal EMA "
                        "(1.0 = no smoothing)")
    p.add_argument("--streams", action="store_true",
                   help="multi-stream mode: the glob matches DIRECTORIES, "
                        "one independent stream each; one frame from every "
                        "stream is enhanced per batched device step "
                        "(MultiStreamVideoEnhancer), outputs mirror the "
                        "per-stream directory names")
    _add_config_args(p)
    p.set_defaults(fn=cmd_video)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
