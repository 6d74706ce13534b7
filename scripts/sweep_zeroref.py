#!/usr/bin/env python
"""Zero-reference training rehabilitation sweep (VERDICT r2 item 3).

The config-3 zero-reference (Zero-DCE) recipe scored SSIM 0.10 on the
round-2 hardened synthetic eval set while the paired objective reached
0.60, so the shipped curve weights quietly switched objective. This sweep
searches the zero-reference loss space (exposure target, spatial-
consistency weight, exposure weight, map-TV weight) for a recipe that at
least beats the classical retinex path (SSIM 0.32), or records the
measured negative.

Compile-once design: ALL candidates share ONE compiled train step — the
loss weights ride in as a traced vector — and one EnhancePipeline is
reused across evals (its jit takes params as an argument). One JSON line
per candidate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from low_light_image_enhancement_tpu.config import PipelineConfig  # noqa: E402
from low_light_image_enhancement_tpu.data.synth_device import (  # noqa: E402
    synth_pair_batch,
)
from low_light_image_enhancement_tpu.eval.runner import eval_lol  # noqa: E402
from low_light_image_enhancement_tpu.models.curve_cnn import (  # noqa: E402
    apply_curve_cnn,
)
from low_light_image_enhancement_tpu.ops.curves import apply_curves  # noqa: E402
from low_light_image_enhancement_tpu.pipeline import (  # noqa: E402
    EnhancePipeline,
)
from low_light_image_enhancement_tpu.train import (  # noqa: E402
    TrainConfig,
    color_constancy_loss,
    exposure_loss,
    init_train_state,
    make_optimizer,
    smoothness_loss,
    spatial_consistency_loss,
)

# (name, exposure_level, w_exposure, w_spatial, w_smooth, w_color)
# Stage 1 (measured, 600 steps): best level35 ssim 0.2863; lower exposure
# target dominated (0.35 >> 0.45 >> 0.60), TV 800 helped at 0.45.
GRID = [
    ("baseline-zdce", 0.60, 10.0, 1.0, 200.0, 5.0),
    ("level45", 0.45, 10.0, 1.0, 200.0, 5.0),
    ("level35", 0.35, 10.0, 1.0, 200.0, 5.0),
    ("spatial20", 0.60, 10.0, 20.0, 200.0, 5.0),
    ("level45-spatial20", 0.45, 10.0, 20.0, 200.0, 5.0),
    ("level45-spatial20-tv800", 0.45, 10.0, 20.0, 800.0, 5.0),
    ("level45-exp5-spatial20", 0.45, 5.0, 20.0, 200.0, 5.0),
    ("level50-spatial50-tv400", 0.50, 10.0, 50.0, 400.0, 5.0),
]
# Stage 3: stage 2 measured level25 0.3115 / level30-tv800 0.3114 (PSNR
# 11.99), and a plain fixed gamma-0.45 scores SSIM 0.354 on this eval set
# (identity scores 0.165, so low targets are NOT converging to a no-op) —
# chase the gamma-like regime: level x high-TV fill-in around 0.20-0.30.
GRID_STAGE3 = [
    ("level20-tv800", 0.20, 10.0, 1.0, 800.0, 5.0),
    ("level22-tv800", 0.22, 10.0, 1.0, 800.0, 5.0),
    ("level25-tv800", 0.25, 10.0, 1.0, 800.0, 5.0),
    ("level28-tv800", 0.28, 10.0, 1.0, 800.0, 5.0),
    ("level25-tv1600", 0.25, 10.0, 1.0, 1600.0, 5.0),
    ("level30-tv1600", 0.30, 10.0, 1.0, 1600.0, 5.0),
    ("level25-spatial5-tv800", 0.25, 10.0, 5.0, 800.0, 5.0),
    ("level22-tv800-color10", 0.22, 10.0, 1.0, 800.0, 10.0),
]
# Stage 4 (final, run at --steps 6000): stage 3 crossed the bar —
# level25-tv1600 0.329, level22-tv800 0.3281, level20-tv800 0.3277, all >
# classical 0.32 — refine the level/TV plateau and let longer training
# decide the shipped recipe.
GRID_STAGE4 = [
    ("level25-tv1600", 0.25, 10.0, 1.0, 1600.0, 5.0),
    ("level22-tv1600", 0.22, 10.0, 1.0, 1600.0, 5.0),
    ("level23-tv1600", 0.23, 10.0, 1.0, 1600.0, 5.0),
    ("level25-tv2400", 0.25, 10.0, 1.0, 2400.0, 5.0),
    ("level27-tv1600", 0.27, 10.0, 1.0, 1600.0, 5.0),
]
# Stage 5 (round-3 defaults re-sweep): the round-3 denoise defaults
# (full-strength sigma=0.2) shifted the optimum UP — the stronger tail
# removes the noise that punished bright targets, so stage 3 re-run under
# the new defaults measured ssim RISING with exposure level (0.20 ->
# 0.480, 0.25 -> 0.513, 0.30 -> 0.520 at 600 steps, all above classical
# 0.505) — chase the brighter-target regime.
GRID_STAGE5 = [
    ("level32-tv1600", 0.32, 10.0, 1.0, 1600.0, 5.0),
    ("level35-tv1600", 0.35, 10.0, 1.0, 1600.0, 5.0),
    ("level38-tv1600", 0.38, 10.0, 1.0, 1600.0, 5.0),
    ("level42-tv1600", 0.42, 10.0, 1.0, 1600.0, 5.0),
    ("level35-tv800", 0.35, 10.0, 1.0, 800.0, 5.0),
    ("level35-tv2400", 0.35, 10.0, 1.0, 2400.0, 5.0),
]
# Stage 2: refine around the stage-1 winner (level 0.25-0.35), vary the
# TV and color-constancy weights that stage 1 held fixed.
GRID_STAGE2 = [
    ("level30", 0.30, 10.0, 1.0, 200.0, 5.0),
    ("level25", 0.25, 10.0, 1.0, 200.0, 5.0),
    ("level35-tv800", 0.35, 10.0, 1.0, 800.0, 5.0),
    ("level30-tv800", 0.30, 10.0, 1.0, 800.0, 5.0),
    ("level35-spatial20-tv800", 0.35, 10.0, 20.0, 800.0, 5.0),
    ("level35-color20", 0.35, 10.0, 1.0, 200.0, 20.0),
    ("level35-color0", 0.35, 10.0, 1.0, 200.0, 0.0),
    ("level35-exp20", 0.35, 20.0, 1.0, 200.0, 5.0),
]


def make_shared_step(tcfg: TrainConfig, opt):
    """One compile for the whole grid: weights arrive as a traced vector
    (level, w_exp, w_spa, w_tv, w_color); data is generated on-device."""
    import optax

    def loss_fn(params, batch, wvec):
        cnn = lambda p, x: apply_curve_cnn(p, x, n_iter=tcfg.n_iter)
        if tcfg.remat:
            cnn = jax.checkpoint(cnn)
        a = cnn(params, batch)
        y = jnp.clip(apply_curves(batch, a), 0.0, 1.0)
        return (
            wvec[1] * exposure_loss(y, wvec[0])
            + wvec[4] * color_constancy_loss(y)
            + wvec[2] * spatial_consistency_loss(batch, y)
            + wvec[3] * smoothness_loss(a)
        )

    @jax.jit
    def step(params, opt_state, key, wvec):
        low, _ = synth_pair_batch(key, tcfg.batch_size, tcfg.crop, tcfg.crop)
        loss, grads = jax.value_and_grad(loss_fn)(params, low, wvec)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--crop", type=int, default=128)
    ap.add_argument("--only", default=None)
    ap.add_argument("--save", default=None)
    ap.add_argument("--stage", type=int, default=1,
                    choices=(1, 2, 3, 4, 5))
    args = ap.parse_args()

    tcfg = TrainConfig(batch_size=args.batch, crop=args.crop,
                       steps=args.steps)
    opt = make_optimizer(tcfg)
    step = make_shared_step(tcfg, opt)
    cfg = PipelineConfig(method="curve")
    pipe = EnhancePipeline(cfg)  # jit takes params as an arg -> one compile

    full = {1: GRID, 2: GRID_STAGE2, 3: GRID_STAGE3,
            4: GRID_STAGE4, 5: GRID_STAGE5}[args.stage]
    grid = [g for g in full if args.only in (None, g[0])]
    best = None
    for name, level, w_exp, w_spa, w_tv, w_col in grid:
        params, opt_state = init_train_state(tcfg, seed=0)
        wvec = jnp.asarray([level, w_exp, w_spa, w_tv, w_col], jnp.float32)
        key = jax.random.PRNGKey(0)
        t0 = time.time()
        loss = None
        for i in range(args.steps):
            key, sub = jax.random.split(key)
            params, opt_state, loss_t = step(params, opt_state, sub, wvec)
            if (i + 1) % 200 == 0 or i == args.steps - 1:
                loss = float(loss_t)
                print(f"#   {name} step {i+1}/{args.steps} "
                      f"loss {loss:.4f} ({time.time()-t0:.0f}s)", flush=True)
        train_s = time.time() - t0

        pipe.model_params = params
        rep = eval_lol(pipeline=pipe, parity=False)
        row = {
            "name": name, "exposure_level": level, "w_exposure": w_exp,
            "w_spatial": w_spa, "w_smooth": w_tv, "w_color": w_col,
            "steps": args.steps,
            "final_loss": round(loss, 4), "train_s": round(train_s, 1),
            "psnr": round(rep["psnr_mean"], 2),
            "ssim": round(rep["ssim_mean"], 4),
        }
        print(json.dumps(row), flush=True)
        if best is None or row["ssim"] > best[1]["ssim"]:
            best = (params, row)
    if best and args.save:
        from low_light_image_enhancement_tpu.models.weights import (
            save_params,
        )

        save_params(best[0], args.save)
        print(f"saved {best[1]['name']} -> {args.save}", flush=True)
    if best:
        print(f"# best: {best[1]['name']} ssim={best[1]['ssim']} "
              f"(classical retinex baseline: ssim 0.32)", flush=True)


if __name__ == "__main__":
    main()
