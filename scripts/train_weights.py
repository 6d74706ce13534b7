#!/usr/bin/env python
"""Train the shipped pretrained weights on device-generated synthetic data.

Produces ``low_light_image_enhancement_tpu/weights/{curve_cnn,fcn}.npz``,
which ``EnhancePipeline`` picks up automatically for the learned methods.
Data batches are generated ON the accelerator (``data.synth_device``), so
the loop is host-transfer-free.

Usage: python scripts/train_weights.py [--steps 1500] [--models curve fcn]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

WEIGHTS_DIR = (
    Path(__file__).resolve().parent.parent
    / "low_light_image_enhancement_tpu" / "weights"
)


def train_curve(steps: int, batch: int, crop: int,
                hybrid: bool = False, objective: str = "paired",
                denoise_in_loss: bool = False,
                loss_tail: str = "bilateral",
                out_name: str = None) -> dict:
    """Curve-CNN training. ``hybrid=True`` trains on retinex-boosted inputs
    (matching the hybrid pipeline, where curves adjust the boosted image)
    and writes curve_hybrid.npz.

    ``objective``: "paired" (L1+SSIM vs the synthetic GT — the shipped-
    weights recipe) or "zeroref" (the Zero-DCE config-3 recipe, no GT).

    Shipped-weights recipe of record for hybrid (round 4):
    ``--models hybrid --steps 10000 --batch 16 --crop 256
    --denoise-in-loss`` — comparing AFTER the pipeline's denoise tail lets
    the CNN sharpen through the blur the tail will apply (19.27 dB / 0.728
    SSIM vs 18.89 / 0.665 without; docs/PERFORMANCE.md @84fe805)."""
    import jax as _jax

    from low_light_image_enhancement_tpu.config import PipelineConfig
    from low_light_image_enhancement_tpu.core import illumination_boost
    from low_light_image_enhancement_tpu.data.synth_device import synth_batch_iter
    from low_light_image_enhancement_tpu.models.weights import save_params
    from low_light_image_enhancement_tpu.train import (
        TrainConfig,
        init_train_state,
        make_paired_curve_train_step,
        make_train_step,
    )

    tcfg = TrainConfig(batch_size=batch, crop=crop, steps=steps,
                       denoise_in_loss=denoise_in_loss,
                       loss_tail_taps=loss_tail)
    params, opt_state = init_train_state(tcfg, seed=0)
    paired = objective == "paired"
    step = (make_paired_curve_train_step if paired else make_train_step)(tcfg)
    data = synth_batch_iter(batch, crop, crop, seed=0)
    boost = _jax.jit(lambda v: illumination_boost(v, PipelineConfig()))
    name = "hybrid" if hybrid else "curve"
    t0 = time.time()
    first = last = None
    for i in range(steps):
        low, high = next(data)
        if hybrid:
            low = boost(low)
        args = (low, high) if paired else (low,)
        params, opt_state, m = step(params, opt_state, *args)
        if i == 0:
            first = float(m["loss"])
        if (i + 1) % 200 == 0 or i == steps - 1:
            last = float(m["loss"])
            extra = f" ssim {float(m['ssim']):.4f}" if paired else ""
            print(f"{name} step {i+1}/{steps} loss {last:.4f}{extra} "
                  f"({batch*(i+1)/(time.time()-t0):.0f} img/s)", flush=True)
    out = out_name or ("curve_hybrid.npz" if hybrid else "curve_cnn.npz")
    save_params(params, WEIGHTS_DIR / out)
    return {"model": name, "objective": objective,
            "denoise_in_loss": denoise_in_loss, "loss_tail": loss_tail,
            "first_loss": first, "final_loss": last}


def train_fcn_weights(steps: int, batch: int, crop: int,
                      features: int = 24, denoise_in_loss: bool = False,
                      loss_tail: str = "bilateral",
                      out_name: str = None) -> dict:
    """Measured width sweep (600x400 bf16, img/s): 8->1633, 16->883,
    24->597, 32->410, 64->446, 128->358 on the original accelerator. A
    trained 64-wide net scored 18.29 dB / 0.895 SSIM vs 24-wide's
    18.78 / 0.888: not worth shipping, 24 stays the default."""
    from low_light_image_enhancement_tpu.data.synth_device import synth_batch_iter
    from low_light_image_enhancement_tpu.models.fcn import init_fcn
    from low_light_image_enhancement_tpu.models.weights import save_params
    from low_light_image_enhancement_tpu.train import (
        TrainConfig,
        make_optimizer,
        make_supervised_train_step,
    )

    tcfg = TrainConfig(features=features, batch_size=batch, crop=crop,
                       steps=steps, denoise_in_loss=denoise_in_loss,
                       loss_tail_taps=loss_tail)
    params = init_fcn(jax.random.PRNGKey(0), features=features)
    opt_state = make_optimizer(tcfg).init(params)
    step = make_supervised_train_step(tcfg)
    data = synth_batch_iter(batch, crop, crop, seed=1)
    t0 = time.time()
    first = last = None
    for i in range(steps):
        low, high = next(data)
        params, opt_state, m = step(params, opt_state, low, high)
        if i == 0:
            first = float(m["loss"])
        if (i + 1) % 200 == 0 or i == steps - 1:
            last = float(m["loss"])
            print(f"fcn step {i+1}/{steps} loss {last:.4f} ssim "
                  f"{float(m['ssim']):.4f} "
                  f"({batch*(i+1)/(time.time()-t0):.0f} img/s)", flush=True)
    save_params(params, WEIGHTS_DIR / (out_name or "fcn.npz"))
    return {"model": "fcn", "denoise_in_loss": denoise_in_loss,
            "loss_tail": loss_tail, "first_loss": first, "final_loss": last}


def train_decom_weights(steps: int, batch: int, crop: int,
                        w_relit: float = 0.0,
                        denoise_in_loss: bool = False,
                        loss_tail: str = "bilateral",
                        out_name: str = None) -> dict:
    from low_light_image_enhancement_tpu.data.synth_device import synth_batch_iter
    from low_light_image_enhancement_tpu.models.decom import init_decom_net
    from low_light_image_enhancement_tpu.models.weights import save_params
    from low_light_image_enhancement_tpu.train import (
        TrainConfig,
        make_decom_train_step,
        make_optimizer,
    )

    tcfg = TrainConfig(batch_size=batch, crop=crop, steps=steps,
                       w_relit=w_relit, denoise_in_loss=denoise_in_loss,
                       loss_tail_taps=loss_tail)
    params = init_decom_net(jax.random.PRNGKey(0))
    opt_state = make_optimizer(tcfg).init(params)
    step = make_decom_train_step(tcfg)
    data = synth_batch_iter(batch, crop, crop, seed=2)
    t0 = time.time()
    first = last = None
    for i in range(steps):
        low, high = next(data)
        params, opt_state, m = step(params, opt_state, low, high)
        if i == 0:
            first = float(m["loss"])
        if (i + 1) % 200 == 0 or i == steps - 1:
            last = float(m["loss"])
            extra = (f" relit_ssim {float(m['relit_ssim']):.4f}"
                     if "relit_ssim" in m else "")
            print(f"decom step {i+1}/{steps} loss {last:.4f} recon "
                  f"{float(m['recon']):.4f}{extra} "
                  f"({batch*(i+1)/(time.time()-t0):.0f} img/s)", flush=True)
    save_params(params, WEIGHTS_DIR / (out_name or "decom.npz"))
    return {"model": "decom", "w_relit": w_relit,
            "denoise_in_loss": denoise_in_loss, "loss_tail": loss_tail,
            "first_loss": first, "final_loss": last}


def main() -> None:
    # Persistent XLA compile cache: the guided-in-loss bwd at crop 256
    # measures ~5.6 min of compile; repeat/retry runs skip it.
    from low_light_image_enhancement_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--models", nargs="*", default=["curve", "fcn"])
    ap.add_argument("--objective", default="paired",
                    choices=("paired", "zeroref"),
                    help="curve/hybrid training objective (paired = shipped-"
                         "weights recipe; zeroref = Zero-DCE config-3 recipe)")
    ap.add_argument("--denoise-in-loss", action="store_true",
                    help="paired objective compares AFTER the pipeline's "
                         "denoise tail (VERDICT r3 item 7 experiment)")
    ap.add_argument("--loss-tail", default="bilateral",
                    choices=("bilateral", "guided"),
                    help="WHICH tail --denoise-in-loss trains through "
                         "(guided = the quality-preset guided filter, "
                         "VERDICT r4 item 3)")
    ap.add_argument("--w-relit", type=float, default=0.0,
                    help="decom: weight of the materialized-relit-image "
                         "L1+SSIM term (0 = pure decomposition objective)")
    ap.add_argument("--out-name", default=None,
                    help="override the output .npz filename (experiments)")
    args = ap.parse_args()
    print("backend:", jax.default_backend(), flush=True)
    for model in args.models:
        if model == "curve":
            print(train_curve(args.steps, args.batch, args.crop,
                              objective=args.objective,
                              denoise_in_loss=args.denoise_in_loss,
                              loss_tail=args.loss_tail,
                              out_name=args.out_name), flush=True)
        elif model == "hybrid":
            print(train_curve(args.steps, args.batch, args.crop, hybrid=True,
                              objective=args.objective,
                              denoise_in_loss=args.denoise_in_loss,
                              loss_tail=args.loss_tail,
                              out_name=args.out_name),
                  flush=True)
        elif model == "fcn":
            print(train_fcn_weights(args.steps, args.batch, args.crop,
                                    denoise_in_loss=args.denoise_in_loss,
                                    loss_tail=args.loss_tail,
                                    out_name=args.out_name),
                  flush=True)
        elif model == "decom":
            print(train_decom_weights(args.steps, args.batch, args.crop,
                                      w_relit=args.w_relit,
                                      denoise_in_loss=args.denoise_in_loss,
                                      loss_tail=args.loss_tail,
                                      out_name=args.out_name),
                  flush=True)


if __name__ == "__main__":
    main()
