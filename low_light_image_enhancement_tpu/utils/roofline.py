"""Analytic per-image cost: FLOPs and memory bytes of one enhancement or
one training step, and the rates a measured throughput implies.

Conventions (stated once, used everywhere):

* one FMA = 2 FLOPs; one transcendental (exp/log/sigmoid) = 8 FLOPs (an
  order-of-magnitude convention, not a measured instruction count);
* FLOP counts are the *algorithmic* work of the math of record, split into
  conv FLOPs (the convolution contractions) and pixel FLOPs (everything
  per-pixel);
* bytes are the *algorithmic minimum* device-memory traffic: graph inputs
  + outputs + unavoidable inter-stage seams (the CNN's activations between
  conv layers, the curve maps). Real traffic is >= this.

No device peak is assumed here: a share of a peak needs the peak table of
the benchmark, keyed by ``device_kind``.
"""

from __future__ import annotations

import dataclasses

from low_light_image_enhancement_tpu.config import PipelineConfig

_TRANSCENDENTAL = 8  # FLOPs per exp/log/sigmoid, by convention


@dataclasses.dataclass(frozen=True)
class Cost:
    """Per-image algorithmic cost of one enhancement at (h, w)."""

    conv_flops: float  # conv contraction FLOPs (2 * kh*kw*cin*cout / out px)
    pixel_flops: float  # per-pixel math FLOPs
    mem_bytes: float   # algorithmic-minimum device-memory traffic


def _conv_flops(h: int, w: int, sizes, k: int = 3) -> float:
    """2 * k*k*cin*cout FLOPs per output pixel, summed over layers."""
    return float(sum(2 * k * k * cin * cout * h * w for cin, cout in sizes))


def _denoise_flops_per_px(cfg: PipelineConfig) -> float:
    """Bilateral tail: per tap — guide diff + square (2), range weight
    (transcendental for 'exp', 2 for 'epan'), weight/value accumulate
    (2 FMAs = 4). Luma guide shares the weight plane across channels
    (3 value FMAs instead of recomputing weights); perchannel pays the
    weight per channel. Plus the guide mean, the final divide (~4) and the
    strength lerp (2) per channel."""
    if cfg.denoise_strength <= 0.0:
        return 0.0
    taps = 6 if cfg.denoise_taps == "sep" else 9
    w_range = _TRANSCENDENTAL if cfg.denoise_kernel == "exp" else 2
    per_tap_weight = 2 + w_range
    if cfg.denoise_guide == "luma":
        per_px = 3 + taps * (per_tap_weight + 3 * 2) + 3 * (4 + 2)
    else:
        per_px = 3 * (taps * (per_tap_weight + 2 * 2) + 4 + 2)
    return float(per_px)


def _illum_flops_per_px(cfg: PipelineConfig) -> float:
    """max-RGB (2) + separable blur (2 passes x (2r+1) FMAs) + clip (2) +
    gain exp/log chain (log + mul + exp ~= 2*T + 1) + 3-channel apply
    (mul + clip = 3 * 3)."""
    blur = 2 * (2 * cfg.blur_radius + 1) * 2
    return 2 + blur + 2 + (2 * _TRANSCENDENTAL + 1) + 9


def pipeline_cost(cfg: PipelineConfig, h: int, w: int) -> Cost:
    """Algorithmic per-image cost of ``EnhancePipeline`` at (h, w) for
    ``cfg.method``, following the math of record (core.py / blocks.py).
    u8 io: 3 bytes/px in + 3 out."""
    px = float(h * w)
    io_bytes = 6.0 * px
    norm_quant = 1 + 3  # u8->f32 mul; round+clip+cast per channel ~ 1 each
    act = 2 if cfg.compute_dtype == "bfloat16" else 4  # activation bytes

    if cfg.method == "retinex":
        pix = _illum_flops_per_px(cfg) + _denoise_flops_per_px(cfg)
        return Cost(0.0, (pix + norm_quant) * px, io_bytes)

    ds = cfg.curve_downsample
    f, n = cfg.curve_features, cfg.curve_iters
    curve_sizes = [(3, f), (f, f), (f, f), (f, f), (2 * f, f), (2 * f, f),
                   (2 * f, 3 * n)]
    # curve tail: n_iter x 3 channels x (y + a*y*(1-y): 2 FMA-ish = 4)
    curve_tail = n * 3 * 4

    if cfg.method in ("curve", "hybrid"):
        conv = _conv_flops(h // ds, w // ds, curve_sizes)
        # CNN activations between conv layers round-trip device memory
        # (write + read) at the compute dtype; so do the f32 curve maps
        inter = [f, f, f, f, f, f]  # outputs of c1..c6 (c7 = the maps)
        act_bytes = sum(2 * c * act for c in inter) * px / (ds * ds)
        maps_bytes = 2 * n * 3 * 4 * px / (ds * ds)
        relu = (6 * f + 3 * n) * 2 / (ds * ds)  # relu/tanh-ish per layer px
        pix = norm_quant + curve_tail + relu + _denoise_flops_per_px(cfg)
        if ds > 1:
            pix += n * 3 * 8  # 2-D map upsample: 2 lerps x ~4 per iter/ch
        if cfg.method == "hybrid":
            pix += _illum_flops_per_px(cfg)
        return Cost(conv, pix * px, io_bytes + act_bytes + maps_bytes)

    if cfg.method == "fcn":
        depth, feat = 7, 24
        sizes = [(3, feat)] + [(feat, feat)] * (depth - 1)
        conv = _conv_flops(h, w, sizes) + 2 * feat * 3 * px  # + 1x1 head
        act_bytes = depth * 2 * feat * act * px
        pix = (norm_quant + depth * feat * 2  # leaky_relu per layer px
               + _TRANSCENDENTAL * 3) * px    # sigmoid head per channel
        return Cost(conv, pix, io_bytes + act_bytes)

    if cfg.method == "decom":
        feat = 32
        sizes = [(4, feat), (feat, feat), (feat, feat), (feat, feat),
                 (feat, 4)]
        conv = _conv_flops(h, w, sizes)
        act_bytes = 4 * 2 * feat * act * px
        # relight: L**decom_gamma (exp+log) + multiply + denoise tail
        pix = (norm_quant + 2 * _TRANSCENDENTAL + 3
               + _denoise_flops_per_px(cfg)) * px
        return Cost(conv, pix, io_bytes + act_bytes)

    raise ValueError(f"no roofline model for method {cfg.method!r}")


# ------------------------------------------------------------------ #
# Training step (config 3): fwd + bwd + update
# ------------------------------------------------------------------ #

_CURVE_SIZES = lambda f, n: [(3, f), (f, f), (f, f), (f, f), (2 * f, f),
                             (2 * f, f), (2 * f, 3 * n)]


def train_step_cost(features: int, n_iter: int, crop: int,
                    remat: bool = True,
                    compute_dtype: str = "float32") -> Cost:
    """Per-IMAGE algorithmic cost of one curve-CNN training step (the
    config-3 workload: zero-reference loss, fwd + bwd + adamw update).

    Conventions on top of the module header's:
    * backward conv FLOPs = 2x forward (one dgrad + one wgrad contraction
      of the same shape per layer); ``remat`` adds one more forward
      (jax.checkpoint recomputes activations in the bwd pass) -> 4x fwd
      with remat, 3x without;
    * bytes: batch in (f32 planar) + per-layer activations at the
      compute dtype crossing device memory twice per materialization (write + read),
      materialized twice with remat (fwd + recompute) plus gradients once;
      params/optimizer state are O(100 KB) for this net — charged once,
      negligible vs activations at config-3 sizes;
    * the loss's pooled terms and the curve application are pixel work of
      the same order as inference's per-pixel tail — counted via the
      inference model's curve tail constant.
    """
    px = float(crop * crop)
    sizes = _CURVE_SIZES(features, n_iter)
    fwd_conv = _conv_flops(crop, crop, sizes)
    passes = 4.0 if remat else 3.0
    conv = passes * fwd_conv

    act = 2 if compute_dtype == "bfloat16" else 4
    inter = [features] * 6  # c1..c6 outputs; c7 emits the maps
    act_mat = 2.0 if remat else 1.0  # materializations of the fwd acts
    act_bytes = sum(2 * c * act for c in inter) * px * act_mat
    grad_bytes = sum(2 * c * act for c in inter) * px  # dgrad traffic
    maps_bytes = 2 * n_iter * 3 * 4 * px  # curve maps (f32) fwd + bwd
    io_bytes = 2 * 3 * 4 * px  # f32 planar batch in, read fwd + recompute
    # per-pixel loss work: curves fwd+bwd (~3x fwd), pools, TV
    pix = (n_iter * 3 * 4 * 3 + 40) * px
    return Cost(conv, pix, io_bytes + act_bytes + grad_bytes + maps_bytes)


def achieved(cost: Cost, images_per_sec: float) -> dict:
    """The operation and byte rates a measured throughput implies, beside
    the per-image counts. Rates only: no peak, no utilization."""
    return {
        "conv_flops_per_img": cost.conv_flops,
        "pixel_flops_per_img": cost.pixel_flops,
        "mem_bytes_per_img": cost.mem_bytes,
        "achieved_conv_tflops": cost.conv_flops * images_per_sec / 1e12,
        "achieved_pixel_tflops": cost.pixel_flops * images_per_sec / 1e12,
        "achieved_mem_gbps": cost.mem_bytes * images_per_sec / 1e9,
    }
