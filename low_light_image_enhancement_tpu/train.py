"""Zero-reference training for the curve-estimation CNN (BASELINE.json
config 3: 512x512 batch-64 on one device).

Zero-DCE-family losses — no paired ground truth needed:
  * exposure control: local mean luminance pulled toward a target level
  * color constancy: channel means kept close (gray-world prior)
  * spatial consistency: local gradients of output match the input
  * illumination smoothness: TV penalty on the curve parameter maps

Data parallelism is sharding-first: params live replicated, the batch is
sharded over the mesh, and XLA inserts the gradient all-reduce
(SURVEY.md §3.3) — no explicit pmap/psum plumbing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from low_light_image_enhancement_tpu.config import PipelineConfig
from low_light_image_enhancement_tpu.models.curve_cnn import (
    apply_curve_cnn,
    init_curve_cnn,
)
from low_light_image_enhancement_tpu.ops.curves import apply_curves


# --------------------------------------------------------------------- loss #

def _avg_pool_plane(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """Non-overlapping k x k mean pool over the last two axes."""
    return lax.reduce_window(
        x, 0.0, lax.add, (1,) * (x.ndim - 2) + (k, k),
        (1,) * (x.ndim - 2) + (k, k), "VALID",
    ) / float(k * k)


def exposure_loss(y: jnp.ndarray, level: float = 0.6, patch: int = 16):
    """Mean squared distance of 16x16 local luminance from the target."""
    gray = jnp.mean(y, axis=-3)
    pooled = _avg_pool_plane(gray, patch)
    return jnp.mean((pooled - level) ** 2)


def color_constancy_loss(y: jnp.ndarray):
    mean_rgb = jnp.mean(y, axis=(-2, -1))  # (..., 3)
    r, g, b = mean_rgb[..., 0], mean_rgb[..., 1], mean_rgb[..., 2]
    return jnp.mean((r - g) ** 2 + (r - b) ** 2 + (g - b) ** 2)


def spatial_consistency_loss(x: jnp.ndarray, y: jnp.ndarray, patch: int = 4):
    """Pooled-gradient agreement between input and output."""
    gx = _avg_pool_plane(jnp.mean(x, axis=-3), patch)
    gy = _avg_pool_plane(jnp.mean(y, axis=-3), patch)

    def grads(g):
        dh = g[..., 1:, :] - g[..., :-1, :]
        dw = g[..., :, 1:] - g[..., :, :-1]
        return dh, dw

    xh, xw = grads(gx)
    yh, yw = grads(gy)
    return jnp.mean((jnp.abs(yh) - jnp.abs(xh)) ** 2) + jnp.mean(
        (jnp.abs(yw) - jnp.abs(xw)) ** 2
    )


def smoothness_loss(a: jnp.ndarray):
    """Total variation of the curve maps (..., n_iter, 3, H, W)."""
    dh = a[..., 1:, :] - a[..., :-1, :]
    dw = a[..., :, 1:] - a[..., :, :-1]
    return jnp.mean(dh * dh) + jnp.mean(dw * dw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    features: int = 32
    n_iter: int = 8
    batch_size: int = 64
    crop: int = 512
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    # 600 is the zero-reference recipe's measured early-stop point (eval
    # SSIM degrades monotonically past it — see the recipe note below);
    # the longer-horizon objectives (paired/fcn/decom) pass --steps.
    steps: int = 600
    # Zero-reference loss weights: the swept recipe of record
    # (scripts/sweep_zeroref.py stage 5 "level32-tv1600" under the round-3
    # denoise defaults — 13.1 dB / SSIM 0.519 on the hardened eval set vs
    # classical retinex 10.6 / 0.505; the round-2 optimum was level 0.25
    # before the full-strength denoise tail shifted it brighter, and the
    # textbook Zero-DCE magnitudes exposure_level 0.6 / w_smooth 200
    # measure far below both — docs/PERFORMANCE.md @84fe805 zero-reference section.
    # Eval SSIM degrades monotonically PAST ~600 steps on this objective
    # (600: 0.519, 2000: 0.513, 6000: 0.503) — the shipped weights stop
    # at 600).
    w_exposure: float = 10.0
    w_color: float = 5.0
    w_spatial: float = 1.0
    w_smooth: float = 1600.0
    # TV weight for the *paired* curve objective (paired_curve_loss): much
    # weaker than the zero-reference prior — the GT supplies the structure.
    w_smooth_paired: float = 20.0
    exposure_level: float = 0.32
    log_every: int = 50
    checkpoint_every: int = 500
    # bf16 conv compute: loss identical to 4 decimals against f32 compute
    # (scripts/bench_configs.py --configs 3 emits both arms), at half the
    # activation bytes; nothing in these losses needs f32 activations.
    # Recipes of record before that change trained f32 — set
    # compute_dtype="float32" to reproduce them.
    compute_dtype: str = "bfloat16"
    # Rematerialize the CNN forward in the backward pass (jax.checkpoint):
    # at the spec'd config-3 size (512x512 batch 64) stored conv activations
    # alone are ~13 GB.
    remat: bool = True
    # Gradient accumulation: split each batch into `microbatch`-sized chunks
    # scanned sequentially, summing grads before one optimizer update —
    # numerically the full-batch step at a fraction of peak activation
    # memory. None = no accumulation.
    microbatch: Optional[int] = None
    # Exponential moving average of the weights (decay per step; 0.999 is
    # the usual scale). When set, the training loop tracks EMA params on
    # device, checkpoints them alongside the raw params, and RETURNS the
    # EMA params — the weights one ships/evaluates. None = off.
    ema_decay: Optional[float] = None
    # Apply the pipeline's full-strength denoise tail inside the PAIRED
    # curve loss before comparing to GT (VERDICT r3 item 7: the shipped
    # hybrid weights optimized pre-denoise output while inference denoises
    # — training through the tail lets the CNN anticipate it). The
    # bilateral is differentiable; clamp-shift boundary on the crop.
    denoise_in_loss: bool = False
    # WHICH tail the loss trains through (VERDICT r4 item 3: "tail choice
    # is part of the training contract" was round 4's measured lesson, yet
    # nothing trained through the guided tail that defines the quality
    # frontier). "bilateral" = the shipping default; "guided" = the
    # quality-preset in-kernel guided filter (ops.guided — integral-image-
    # free shift cores, differentiable jnp).
    loss_tail_taps: str = "bilateral"
    loss_tail_guided_radius: int = 4
    # Decom objective extension (VERDICT r4 item 3): weight of an L1+SSIM
    # term on the MATERIALIZED relit image y = R_low * L_low**relit_gamma
    # (plus the loss tail when denoise_in_loss) vs the bright GT — the
    # image the decom pipeline actually ships, which the pure
    # decomposition objective never scores. 0 = the round-3/4 objective.
    w_relit: float = 0.0
    relit_gamma: float = 0.08  # PipelineConfig.decom_gamma default
    # Metric-based early stopping (VERDICT r3 weak #4: the zero-ref
    # recipe's 600-step stop lived only in a docstring). When eval_every>0
    # AND an eval_fn is passed to the trainer, the loop scores the shipping
    # params (EMA if enabled) every eval_every steps, keeps the best-scoring
    # snapshot, and stops after eval_patience consecutive non-improving
    # evals — returning the BEST params, not the last. 0 = off.
    eval_every: int = 0
    eval_patience: int = 3


def zero_reference_loss(
    params, batch: jnp.ndarray, tcfg: TrainConfig
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """batch: (B, 3, H, W) f32 low-light input in [0, 1]."""
    cnn = lambda p, x: apply_curve_cnn(
        p, x, n_iter=tcfg.n_iter,
        compute_dtype=jnp.dtype(tcfg.compute_dtype),
    )
    if tcfg.remat:
        cnn = jax.checkpoint(cnn)
    a = cnn(params, batch)
    y = jnp.clip(apply_curves(batch, a), 0.0, 1.0)
    if tcfg.denoise_in_loss:
        # score the image the pipeline actually ships (same rationale as
        # the paired losses; _denoise_tail docstring)
        y = _denoise_tail(y, tcfg)
    l_exp = exposure_loss(y, tcfg.exposure_level)
    l_col = color_constancy_loss(y)
    l_spa = spatial_consistency_loss(batch, y)
    l_tv = smoothness_loss(a)
    total = (
        tcfg.w_exposure * l_exp
        + tcfg.w_color * l_col
        + tcfg.w_spatial * l_spa
        + tcfg.w_smooth * l_tv
    )
    return total, {
        "loss": total, "exposure": l_exp, "color": l_col,
        "spatial": l_spa, "smooth": l_tv,
    }


# --------------------------------------------------------------------- step #

def make_optimizer(tcfg: TrainConfig) -> optax.GradientTransformation:
    return optax.adamw(tcfg.learning_rate, weight_decay=tcfg.weight_decay)


def _accumulated_grads(loss_fn, params, tcfg: TrainConfig, *batches):
    """value_and_grad over the whole batch, microbatched via lax.scan when
    tcfg.microbatch is set (mean-of-means == full-batch mean: equal chunks)."""
    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
    mb = tcfg.microbatch
    n = batches[0].shape[0]
    if not mb or mb >= n:
        (_, metrics), grads = grad_fn(params, *batches, tcfg)
        return metrics, grads
    if n % mb:
        raise ValueError(f"batch {n} not divisible by microbatch {mb}")
    chunks = tuple(
        b.reshape(n // mb, mb, *b.shape[1:]) for b in batches
    )

    def body(carry, chunk):
        acc_metrics, acc_grads = carry
        (_, metrics), grads = grad_fn(params, *chunk, tcfg)
        acc_metrics = jax.tree_util.tree_map(jnp.add, acc_metrics, metrics)
        acc_grads = jax.tree_util.tree_map(jnp.add, acc_grads, grads)
        return (acc_metrics, acc_grads), None

    (_, m_shape), _ = jax.eval_shape(
        lambda p, *bs: grad_fn(p, *bs, tcfg), params, *(c[0] for c in chunks)
    )
    zero_m = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), m_shape
    )
    zero_g = jax.tree_util.tree_map(jnp.zeros_like, params)
    (metrics, grads), _ = lax.scan(body, (zero_m, zero_g), chunks)
    scale = mb / n
    metrics = jax.tree_util.tree_map(lambda x: x * scale, metrics)
    grads = jax.tree_util.tree_map(lambda x: x * scale, grads)
    return metrics, grads


def _make_step(
    loss_fn: Callable, n_batch_args: int, tcfg: TrainConfig,
    mesh: Optional[Mesh], spatial_batch: bool = False,
) -> Callable:
    """Generic jitted ``step(params, opt_state, *batch_args)`` for any
    ``loss_fn(params, *batch_args, tcfg) -> (loss, metrics)``. With a mesh,
    batch args are sharded over all mesh axes and params replicated; XLA
    all-reduces gradients.

    ``spatial_batch=True`` shards the crop ROWS over the mesh's "spatial"
    axis instead of folding that axis into the batch dimension: the batch
    (B, 3, H, W) gets spec ("data", None, "spatial", None), and GSPMD
    inserts the conv halo exchanges and partial-reduction collectives for
    the pooled losses — true spatially-parallel training, for crops too
    large to fit one device's memory. Crop rows must divide by the spatial axis
    size."""
    optimizer = make_optimizer(tcfg)

    def step(params, opt_state, *batch_args):
        metrics, grads = _accumulated_grads(
            loss_fn, params, tcfg, *batch_args
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, metrics

    if mesh is None:
        return jax.jit(step)
    batch_sharding = NamedSharding(
        mesh,
        P("data", None, "spatial", None) if spatial_batch
        else P(("data", "spatial")),
    )
    replicated = NamedSharding(mesh, P())
    return jax.jit(
        step,
        in_shardings=(replicated, replicated)
        + (batch_sharding,) * n_batch_args,
        out_shardings=(replicated, replicated, replicated),
    )


def make_train_step(
    tcfg: TrainConfig, mesh: Optional[Mesh] = None,
    spatial_batch: bool = False,
) -> Callable:
    """Zero-reference step: ``step(params, opt_state, batch)``."""
    return _make_step(zero_reference_loss, 1, tcfg, mesh, spatial_batch)


def init_train_state(
    tcfg: TrainConfig, seed: int = 0
) -> Tuple[Any, Any]:
    params = init_curve_cnn(
        jax.random.PRNGKey(seed), features=tcfg.features, n_iter=tcfg.n_iter
    )
    opt_state = make_optimizer(tcfg).init(params)
    return params, opt_state


# --------------------------------------------------------------------- loop #

def _synth_planar_pairs(tcfg: TrainConfig, seed: int, start_step: int):
    """Infinite (low, high) planar f32 pair batches, offset by the restored
    step so a resumed run continues the data stream instead of replaying."""
    from low_light_image_enhancement_tpu.data.synth import synth_batch

    i = start_step * tcfg.batch_size
    while True:
        lows, highs = synth_batch(
            tcfg.batch_size, tcfg.crop, tcfg.crop, seed=seed, start=i
        )
        i += tcfg.batch_size
        to_planar = lambda a: jnp.transpose(
            jnp.asarray(a, jnp.float32) / 255.0, (0, 3, 1, 2)
        )
        yield to_planar(lows), to_planar(highs)


def _run_training_loop(
    tcfg: TrainConfig,
    params,
    opt_state,
    make_step_fn: Callable,
    data_factory: Callable,
    mesh: Optional[Mesh],
    checkpoint_dir: Optional[str],
    resume: bool,
    log_fn: Optional[Callable[[Dict[str, float]], None]],
    eval_fn: Optional[Callable] = None,
):
    """Shared trainer: checkpoint restore -> data stream (offset to the
    restored step) -> step loop with logging + periodic/final checkpointing.
    ``data_factory(start_step)`` yields tuples of step-fn batch args.

    ``eval_fn(params) -> float`` (higher is better) enables metric-based
    early stopping when ``tcfg.eval_every > 0``: the loop evaluates the
    shipping params (EMA if enabled) every ``eval_every`` steps, keeps the
    best snapshot, and stops after ``eval_patience`` consecutive
    non-improving evals — returning the BEST-scoring params."""
    ema_params = None
    ema_update = None
    if tcfg.ema_decay is not None:
        if not 0.0 < tcfg.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1): {tcfg.ema_decay}")
        ema_params = params  # EMA starts at the init/restored weights
        d = tcfg.ema_decay
        ema_update = jax.jit(
            lambda e, p: jax.tree_util.tree_map(
                lambda a, b: d * a + (1.0 - d) * b, e, p
            )
        )

    def _state(step):
        s = {"params": params, "opt_state": opt_state, "step": step}
        if ema_params is not None:
            s["ema_params"] = ema_params
        return s

    start_step = 0
    ckpt = None
    if checkpoint_dir is not None:
        from low_light_image_enhancement_tpu.utils.checkpoint import (
            CheckpointManager,
        )

        ckpt = CheckpointManager(checkpoint_dir)
        if resume:
            # tolerate EMA-flag drift across runs: a pre-EMA checkpoint
            # resumed with ema_decay set (EMA restarts at the restored
            # params), or an EMA checkpoint resumed without the flag (the
            # extra tree is ignored) — either template may mismatch the
            # on-disk structure, so fall back to the other
            try:
                restored = ckpt.restore_latest(_state(0))
            except Exception:
                alt = dict(_state(0))
                if "ema_params" in alt:
                    alt.pop("ema_params")
                else:
                    alt["ema_params"] = params
                restored = ckpt.restore_latest(alt)
            if restored is not None:
                params = restored["params"]
                opt_state = restored["opt_state"]
                start_step = int(restored["step"])
                if ema_params is not None:
                    ema_params = restored.get("ema_params", params)

    data_iter = data_factory(start_step)
    step_fn = make_step_fn(tcfg, mesh)
    history = []
    best_params, best_score, stale_evals = None, float("-inf"), 0
    early_stop = eval_fn is not None and tcfg.eval_every > 0
    t0 = time.time()
    last_step = start_step
    for step_idx in range(start_step, tcfg.steps):
        batch_args = next(data_iter)
        if not isinstance(batch_args, tuple):
            batch_args = (batch_args,)
        params, opt_state, metrics = step_fn(params, opt_state, *batch_args)
        last_step = step_idx + 1
        if ema_params is not None:
            ema_params = ema_update(ema_params, params)
        if (step_idx + 1) % tcfg.log_every == 0 or step_idx == start_step:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step_idx
            m["imgs_per_sec"] = (
                tcfg.batch_size * (step_idx + 1 - start_step)
                / max(time.time() - t0, 1e-9)
            )
            history.append(m)
            if log_fn is not None:
                log_fn(m)
        if early_stop and (step_idx + 1) % tcfg.eval_every == 0:
            shipping = ema_params if ema_params is not None else params
            score = float(eval_fn(shipping))
            em = {"step": step_idx, "eval_score": score}
            history.append(em)
            if log_fn is not None:
                log_fn(em)
            if score > best_score:
                best_score, stale_evals = score, 0
                # device->host snapshot: the loop keeps training, so the
                # live trees mutate; the best snapshot must not alias them
                best_params = jax.tree_util.tree_map(np.asarray, shipping)
            else:
                stale_evals += 1
                if stale_evals >= tcfg.eval_patience:
                    break
        if ckpt is not None and (step_idx + 1) % tcfg.checkpoint_every == 0:
            ckpt.save(_state(step_idx + 1), step=step_idx + 1)
    if ckpt is not None:
        if last_step > start_step and ckpt.latest_step() != last_step:
            ckpt.save(_state(last_step), step=last_step)
        ckpt.wait()
    if early_stop and best_params is not None:
        return best_params, history
    # with EMA enabled the averaged weights are the shipping artifact
    return (ema_params if ema_params is not None else params), history


def train_curve_cnn(
    tcfg: TrainConfig = TrainConfig(),
    data_iter=None,
    mesh: Optional[Mesh] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    log_fn: Optional[Callable[[Dict[str, float]], None]] = None,
    seed: int = 0,
    objective: str = "zeroref",
    hybrid: bool = False,
    data_factory: Optional[Callable] = None,
    eval_fn: Optional[Callable] = None,
):
    """Config-3 training loop for the curve CNN.

    ``objective``: "zeroref" (the Zero-DCE config-3 recipe, input-only) or
    "paired" (L1 + SSIM vs ground truth + weak TV — the recipe that
    produced the SHIPPED curve/hybrid weights, `scripts/train_weights.py`).
    ``hybrid``: train on retinex-illumination-boosted inputs, matching the
    hybrid pipeline where the curves adjust the boosted image.

    ``data_iter`` yields (B, 3, H, W) f32 batches for zeroref, or
    (low, high) pairs for paired; defaults to the hardened synthetic
    stream. ``data_factory(start_step) -> iterator`` is the resume-aware
    form (a checkpoint restore re-creates the stream at the restored
    step — LOLDataset.train_batch_plans supports this); it wins over
    ``data_iter`` when both are given. Returns (params,
    metrics_history)."""
    if objective not in ("zeroref", "paired"):
        raise ValueError(f"objective must be 'zeroref' or 'paired': "
                         f"{objective!r}")
    params, opt_state = init_train_state(tcfg, seed)
    paired = objective == "paired"

    def _boost(low):
        if not hybrid:
            return low
        from low_light_image_enhancement_tpu.config import PipelineConfig
        from low_light_image_enhancement_tpu.core import illumination_boost

        return illumination_boost(low, PipelineConfig())

    if data_factory is not None or data_iter is not None:
        # hybrid's boost applies to external data too: the curves adjust
        # the boosted image at inference, so they must train on it
        def _ext(start):
            src = (data_factory(start) if data_factory is not None
                   else iter(data_iter))
            for item in src:
                if paired:
                    low, high = item
                    yield _boost(jnp.asarray(low)), jnp.asarray(high)
                else:
                    yield _boost(jnp.asarray(item))

        factory = _ext
    elif paired:
        factory = lambda start: (
            (_boost(low), high)
            for low, high in _synth_planar_pairs(tcfg, seed, start)
        )
    else:
        factory = lambda start: (
            _boost(low) for low, _ in _synth_planar_pairs(tcfg, seed, start)
        )
    make_fn = make_paired_curve_train_step if paired else make_train_step
    if eval_fn is None and tcfg.eval_every > 0:
        eval_fn = make_synth_eval_fn(tcfg, hybrid=hybrid)
    return _run_training_loop(
        tcfg, params, opt_state, make_fn, factory, mesh,
        checkpoint_dir, resume, log_fn, eval_fn=eval_fn,
    )


def make_synth_eval_fn(
    tcfg: TrainConfig, hybrid: bool = False, n_images: int = 8, seed: int = 17,
) -> Callable:
    """Held-out early-stop metric for the curve trainers: mean SSIM vs GT
    on a FIXED synthetic batch (disjoint seed from the training stream),
    scored through the same forward the pipeline ships — boost (hybrid),
    curves, and the full-strength denoise tail. Used by
    ``tcfg.eval_every``-based early stopping; the zero-reference objective
    especially needs it (its loss keeps falling while eval SSIM peaks
    early — the shipped-recipe 600-step stop, docs/PERFORMANCE.md @84fe805)."""
    from low_light_image_enhancement_tpu.core import illumination_boost
    from low_light_image_enhancement_tpu.eval.metrics import ssim

    lows, highs = _synth_eval_pair(tcfg, n_images, seed)

    @jax.jit
    def score(params):
        x = illumination_boost(lows, PipelineConfig()) if hybrid else lows
        a = apply_curve_cnn(params, x, n_iter=tcfg.n_iter)
        y = jnp.clip(apply_curves(x, a), 0.0, 1.0)
        return jnp.mean(ssim(_denoise_tail(y, tcfg), highs))

    return score


def _synth_eval_pair(tcfg: TrainConfig, n_images: int, seed: int):
    from low_light_image_enhancement_tpu.data.synth import synth_batch

    lows, highs = synth_batch(n_images, tcfg.crop, tcfg.crop, seed=seed)
    to_planar = lambda u8: jnp.transpose(
        jnp.asarray(u8, jnp.float32) / 255.0, (0, 3, 1, 2)
    )
    return to_planar(lows), to_planar(highs)


# ------------------------------------------------- decomposition (decom) -- #

def decom_loss(
    params, low: jnp.ndarray, high: jnp.ndarray, tcfg: "TrainConfig",
    w_equal_r: float = 0.01, w_smooth: float = 0.1,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """RetinexNet-style decomposition objective on (low, high) pairs:
    both images must reconstruct as R*L, share one reflectance, and carry
    structure-aware smooth illumination."""
    from low_light_image_enhancement_tpu.models.decom import apply_decom_net

    r_lo, l_lo = apply_decom_net(params, low)
    r_hi, l_hi = apply_decom_net(params, high)
    recon = jnp.mean(jnp.abs(r_lo * l_lo - low)) + jnp.mean(
        jnp.abs(r_hi * l_hi - high)
    )
    equal_r = jnp.mean(jnp.abs(r_lo - r_hi))

    def smooth(l, img):
        # illumination gradients cheap where image gradients are strong
        gray = jnp.mean(img, axis=-3, keepdims=True)
        dh_l = jnp.abs(l[..., 1:, :] - l[..., :-1, :])
        dw_l = jnp.abs(l[..., :, 1:] - l[..., :, :-1])
        dh_i = jnp.abs(gray[..., 1:, :] - gray[..., :-1, :])
        dw_i = jnp.abs(gray[..., :, 1:] - gray[..., :, :-1])
        return jnp.mean(dh_l * jnp.exp(-10.0 * dh_i)) + jnp.mean(
            dw_l * jnp.exp(-10.0 * dw_i)
        )

    sm = smooth(l_lo, low) + smooth(l_hi, high)
    total = recon + w_equal_r * equal_r + w_smooth * sm
    metrics = {"loss": total, "recon": recon, "equal_r": equal_r,
               "smooth": sm}
    if tcfg.w_relit > 0.0:
        # Materialize the image the decom pipeline SHIPS (VERDICT r4
        # item 3: the pure decomposition objective never scores it):
        # y = R_low * L_low**decom_gamma, through the loss tail when
        # denoise_in_loss — mirroring blocks.enhance_learned_block's decom
        # branch — and compare to the bright GT like the paired losses.
        from low_light_image_enhancement_tpu.config import PipelineConfig
        from low_light_image_enhancement_tpu.eval.metrics import ssim

        eps = PipelineConfig().illum_eps
        l_boost = jnp.clip(l_lo, eps, 1.0) ** tcfg.relit_gamma
        y = jnp.clip(r_lo * l_boost, 0.0, 1.0)
        if tcfg.denoise_in_loss:
            y = _denoise_tail(y, tcfg)
        relit_l1 = jnp.mean(jnp.abs(y - high))
        relit_s = jnp.mean(ssim(y, high))
        relit = relit_l1 + 0.5 * (1.0 - relit_s)
        total = total + tcfg.w_relit * relit
        metrics.update({"loss": total, "relit_l1": relit_l1,
                        "relit_ssim": relit_s})
    return total, metrics


def make_decom_train_step(
    tcfg: "TrainConfig", mesh: Optional[Mesh] = None
) -> Callable:
    """Decomposition step: ``step(params, opt_state, low, high)``."""
    return _make_step(decom_loss, 2, tcfg, mesh)


# ----------------------------------------------------- supervised (FCN) --- #

def _denoise_tail(y: jnp.ndarray,
                  tcfg: Optional["TrainConfig"] = None) -> jnp.ndarray:
    """Apply the pipeline's SHIPPING denoise tail inside a training loss,
    so the net optimizes the image the user actually receives. Moving the
    tail into the loss flipped the round-3 curve-vs-hybrid ranking (+0.06
    SSIM on hybrid — docs/PERFORMANCE.md @84fe805 "denoise-in-loss").

    ``tcfg.loss_tail_taps`` selects WHICH tail (VERDICT r4 item 3):
    "bilateral" (default PipelineConfig, the shipping throughput tail) or
    "guided" (the quality-preset guided filter at
    ``loss_tail_guided_radius`` — the same differentiable shift cores the
    fused kernels mirror)."""
    from low_light_image_enhancement_tpu.config import PipelineConfig
    from low_light_image_enhancement_tpu.ops.denoise import denoise_planar
    from low_light_image_enhancement_tpu.ops.filters import shift2d

    if tcfg is not None and tcfg.loss_tail_taps == "guided":
        pcfg = PipelineConfig(denoise_taps="guided",
                              guided_radius=tcfg.loss_tail_guided_radius)
    elif tcfg is None or tcfg.loss_tail_taps == "bilateral":
        pcfg = PipelineConfig()  # the shipping denoise defaults
    else:
        raise ValueError(
            f"loss_tail_taps must be 'bilateral' or 'guided': "
            f"{tcfg.loss_tail_taps!r}"
        )
    inv2s2 = 1.0 / (2.0 * pcfg.denoise_sigma * pcfg.denoise_sigma)
    return jnp.clip(
        denoise_planar(y, inv2s2, pcfg.denoise_strength, shift2d,
                       pcfg.denoise_kernel, pcfg.denoise_guide,
                       pcfg.denoise_taps, pcfg.guided_radius,
                       pcfg.guided_eps),
        0.0, 1.0,
    )


def paired_loss(
    params, low: jnp.ndarray, high: jnp.ndarray, tcfg: "TrainConfig",
    w_ssim: float = 0.5,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """L1 + (1 - SSIM) supervised loss for the FCN enhancer on (low, high)
    pairs — the paired-data counterpart of the zero-reference losses."""
    from low_light_image_enhancement_tpu.eval.metrics import ssim
    from low_light_image_enhancement_tpu.models.fcn import apply_fcn

    net = lambda p, x: apply_fcn(p, x,
                                 compute_dtype=jnp.dtype(tcfg.compute_dtype))
    if tcfg.remat:
        net = jax.checkpoint(net)
    y = net(params, low)
    if tcfg.denoise_in_loss:
        y = _denoise_tail(jnp.clip(y, 0.0, 1.0), tcfg)
    l1 = jnp.mean(jnp.abs(y - high))
    s = jnp.mean(ssim(y, high))
    total = l1 + w_ssim * (1.0 - s)
    return total, {"loss": total, "l1": l1, "ssim": s}


def make_supervised_train_step(
    tcfg: "TrainConfig", mesh: Optional[Mesh] = None
) -> Callable:
    """Supervised FCN step: ``step(params, opt_state, low, high)``."""
    return _make_step(paired_loss, 2, tcfg, mesh)


def paired_curve_loss(
    params, low: jnp.ndarray, high: jnp.ndarray, tcfg: "TrainConfig",
    w_ssim: float = 0.5,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Supervised counterpart of ``zero_reference_loss`` for the curve CNN:
    L1 + (1 − SSIM) between the curve-enhanced output and the paired ground
    truth, plus a weak TV prior on the maps (``w_smooth_paired``). The
    zero-reference recipe remains the config-3 training path; this objective
    exists because paired data (synthetic or LOL) trains far more faithful
    curves — the shipped weights use it (docs/PERFORMANCE.md @84fe805 quality table).
    """
    from low_light_image_enhancement_tpu.eval.metrics import ssim

    cnn = lambda p, x: apply_curve_cnn(
        p, x, n_iter=tcfg.n_iter,
        compute_dtype=jnp.dtype(tcfg.compute_dtype),
    )
    if tcfg.remat:
        cnn = jax.checkpoint(cnn)
    a = cnn(params, low)
    y = jnp.clip(apply_curves(low, a), 0.0, 1.0)
    if tcfg.denoise_in_loss:
        y = _denoise_tail(y, tcfg)
    l1 = jnp.mean(jnp.abs(y - high))
    s = jnp.mean(ssim(y, high))
    l_tv = smoothness_loss(a)
    total = l1 + w_ssim * (1.0 - s) + tcfg.w_smooth_paired * l_tv
    return total, {"loss": total, "l1": l1, "ssim": s, "smooth": l_tv}


def make_paired_curve_train_step(
    tcfg: "TrainConfig", mesh: Optional[Mesh] = None,
    spatial_batch: bool = False,
) -> Callable:
    """Supervised curve step: ``step(params, opt_state, low, high)``."""
    return _make_step(paired_curve_loss, 2, tcfg, mesh, spatial_batch)


def train_fcn(
    tcfg: TrainConfig = TrainConfig(features=24, batch_size=16, crop=256),
    data_iter=None,
    mesh: Optional[Mesh] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    log_fn: Optional[Callable[[Dict[str, float]], None]] = None,
    seed: int = 0,
    data_factory: Optional[Callable] = None,
):
    """Supervised training loop for the FCN enhancer. ``data_iter`` yields
    (low, high) planar f32 batch pairs; ``data_factory(start_step)`` is the
    resume-aware form (wins over data_iter); defaults to synthetic
    LOL-like pairs. Returns (params, metrics_history)."""
    from low_light_image_enhancement_tpu.models.fcn import init_fcn

    params = init_fcn(jax.random.PRNGKey(seed), features=tcfg.features)
    opt_state = make_optimizer(tcfg).init(params)
    factory = (
        data_factory if data_factory is not None
        else (lambda start: iter(data_iter)) if data_iter is not None
        else (lambda start: _synth_planar_pairs(tcfg, seed, start))
    )
    return _run_training_loop(
        tcfg, params, opt_state, make_supervised_train_step, factory, mesh,
        checkpoint_dir, resume, log_fn,
    )


def train_decom(
    tcfg: TrainConfig = TrainConfig(),
    data_iter=None,
    mesh: Optional[Mesh] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    log_fn: Optional[Callable[[Dict[str, float]], None]] = None,
    seed: int = 0,
    data_factory: Optional[Callable] = None,
):
    """Decomposition-objective training loop for the RetinexNet-style
    DecomNet (the shipped decom.npz recipe). ``data_iter`` yields
    (low, high) planar f32 pairs; ``data_factory(start_step)`` is the
    resume-aware form (wins over data_iter); defaults to the hardened
    synthetic stream. Returns (params, metrics_history)."""
    from low_light_image_enhancement_tpu.models.decom import init_decom_net

    params = init_decom_net(jax.random.PRNGKey(seed))
    opt_state = make_optimizer(tcfg).init(params)
    factory = (
        data_factory if data_factory is not None
        else (lambda start: iter(data_iter)) if data_iter is not None
        else (lambda start: _synth_planar_pairs(tcfg, seed, start))
    )
    return _run_training_loop(
        tcfg, params, opt_state, make_decom_train_step, factory, mesh,
        checkpoint_dir, resume, log_fn,
    )
