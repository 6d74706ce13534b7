"""Pipeline configuration.

Plain frozen dataclasses (hashable → usable as jit static args / cache keys).
One named preset per benchmark config in BASELINE.json:6-12.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Edge-replicate padding margin of the device graph's canvas at the DEFAULT
# config (blur radius 2 + radius-1 bilateral = receptive radius 3 -> 4).
# Round 4 (VERDICT r3 item 3): the margin is no longer a global invariant —
# configs whose per-pixel tail has a larger receptive radius (the guided-
# filter tail: radius 2*guided_radius) get a wider canvas via
# ``canvas_margin(cfg)``; every canvas/plan/halo/band computation derives
# from that. MARGIN stays exported as the floor (and the exact value every
# pre-round-4 config resolves to, so all margin-4 geometry is bit-unchanged).
MARGIN = 4


def denoise_radius(cfg: "PipelineConfig") -> int:
    """Receptive radius (pixels) of the configured denoise tail: radius-1
    bilateral taps, or the guided filter's two cascaded radius-r box means
    (stats, then the a/b smoothing) = 2*r."""
    if cfg.denoise_strength <= 0.0:
        return 0
    if cfg.denoise_taps == "guided":
        return 2 * cfg.guided_radius
    return 1


def canvas_margin(cfg: "PipelineConfig") -> int:
    """Edge-replicate margin of the padded canvas for ``cfg``: the total
    receptive radius of the per-pixel tail (illumination blur where the
    method has one, plus the denoise radius), floored at MARGIN and rounded
    to a multiple of 8 above it (which keeps the curve/hybrid ds
    divisibility for every allowed curve_downsample). All bilateral
    configs resolve to exactly MARGIN=4."""
    # The denoise taps at the first consumed row reach denoise_radius rows
    # toward the canvas edge; those rows must be clear of every wrap-roll
    # corruption band. The corruption sources are PARALLEL (each measured
    # from the canvas edge, none feeds another): the illumination blur's
    # radius, and ds/2 rows for a curve-map upsample at ds in {2, 4}.
    edge = 0
    if cfg.method in ("retinex", "hybrid"):
        edge = cfg.blur_radius
    if cfg.method in ("curve", "hybrid") and cfg.curve_downsample in (2, 4):
        edge = max(edge, cfg.curve_downsample // 2)
    r = denoise_radius(cfg) + edge
    return MARGIN if r <= MARGIN else -(-r // 8) * 8

_METHODS = ("retinex", "curve", "hybrid", "fcn", "decom")
CONV_IMPLS = ("auto", "xla", "gemm", "packed", "packed12")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Configuration of the enhancement device graph.

    All fields are Python scalars so the dataclass is hashable and a config
    change maps to exactly one XLA recompile.
    """

    # --- algorithm selection -------------------------------------------------
    # "retinex": classical illumination-map / reflectance path (no weights).
    # "curve":   Zero-DCE-style learned curve adjustment (needs CNN params).
    # "hybrid":  retinex illumination boost followed by learned curves.
    # "fcn":     supervised context-aggregation FCN enhancer (paired data).
    # "decom":   learned Retinex decomposition (RetinexNet-style) + relight.
    method: str = "retinex"

    # --- retinex / gamma -----------------------------------------------------
    gamma: float = 0.45          # illumination brightening exponent (<1 brightens)
    decom_gamma: float = 0.08    # decom method's illumination exponent in
                                 # y = R * L**decom_gamma. The equal-R loss
                                 # pins R near the well-lit reflectance, so a
                                 # much flatter L than retinex's boost is
                                 # optimal (eval sweep: 0.08 -> 19.4 dB/0.613
                                 # SSIM vs 10.4 dB at the retinex gamma)
    illum_eps: float = 1e-3      # floor for illumination before division
    blur_radius: int = 2         # Gaussian radius for illumination smoothing
    blur_sigma: float = 1.0      # Gaussian sigma for illumination smoothing

    # --- denoise -------------------------------------------------------------
    denoise_strength: float = 1.0   # 0 disables; blend factor toward the
                                    # filtered image. Full blend measured
                                    # better on EVERY method and metric on
                                    # the hardened eval set (with the sigma
                                    # default below: retinex SSIM 0.32 ->
                                    # 0.505, decom 0.63 -> 0.742 — the
                                    # round-3 quality table in
                                    # docs/PERFORMANCE.md @84fe805 is the record);
                                    # the bilateral is edge-preserving so
                                    # full blend does not smear edges.
                                    # Kernel cost identical (the blend is
                                    # one in-kernel lerp).
    denoise_sigma: float = 0.2      # range sigma of the bilateral-lite
                                    # filter. Swept at full blend on the
                                    # hardened eval set: 0.12->0.2 gains
                                    # +0.024 SSIM (curve) / +0.009
                                    # (retinex) while a 0.5-contrast edge
                                    # still weighs only e^-3.1 ~= 0.04
                                    # (strongly edge-preserving); past 0.3
                                    # the gains (<+0.01 to sigma=3) come
                                    # from degrading toward a plain box
                                    # blur that the synthetic noise
                                    # rewards, so 0.2 is the ship point.
    denoise_kernel: str = "exp"     # range weight: "exp" (classic Gaussian
                                    # bilateral, the default) or "epan"
                                    # (squared Epanechnikov, transcendental-
                                    # free; see ops/denoise.py)
    denoise_taps: str = "sep"       # "sep" (default): separable 3+3-tap
                                    # bilateral, measured-identical eval
                                    # quality at 6 taps instead of 9;
                                    # "full": the exact 9-tap 3x3
                                    # bilateral; "guided":
                                    # the guided-filter tail (He et al.,
                                    # radius guided_radius box-mean
                                    # cascade) — the measured quality
                                    # lever on the classical path (SSIM
                                    # 0.56-0.61 vs the bilateral's 0.505
                                    # at the op-level probe); widens the
                                    # canvas margin (canvas_margin)
    guided_radius: int = 2          # box radius of the guided tail (only
                                    # read when denoise_taps="guided");
                                    # receptive radius is 2x this
    # Guided-filter edge/flat variance threshold. 1e-2 measured better than
    # 3e-3 on EVERY method at both radii (retinex r=2 SSIM 0.599 -> 0.636,
    # decom 0.889 -> 0.892; docs/PERFORMANCE.md @84fe805 guided table) — round 4
    # default change.
    guided_eps: float = 1e-2
                                    # threshold (guide is in [0, 1])
    denoise_guide: str = "luma"     # "luma" (default): joint bilateral
                                    # guided by the channel-mean luminance —
                                    # one weight plane per tap, chroma
                                    # smoothing aligned with luminance edges
                                    # (measured: perf-neutral, +0.3 dB /
                                    # +0.03 SSIM over "perchannel" on the
                                    # eval set); "perchannel": independent
                                    # range weights per channel

    # --- curve CNN -----------------------------------------------------------
    curve_iters: int = 8         # LE-curve iterations (Zero-DCE uses 8)
    curve_features: int = 32     # conv width of the curve estimator
    curve_downsample: int = 1    # estimate curves at 1/N resolution and
                                 # bilinearly upsample the maps (curves are
                                 # spatially smooth by construction — the TV
                                 # loss — so N=4 loses almost nothing)

    # --- execution -----------------------------------------------------------
    use_pallas: bool = True      # run the fused retinex kernel where the
                                 # backend and its coverage allow
                                 # (backend.use_kernel)
    compute_dtype: str = "bfloat16"  # CNN conv compute dtype (curve/fcn/
                                 # decom); the per-pixel tail math stays
                                 # f32 regardless. Set "float32" for the
                                 # f32-reference path.

    conv_impl: str = "auto"      # conv-stack lowering for the learned
                                 # models' INFERENCE path:
                                 # "auto" / "xla": lax.conv_general_dilated
                                 # as-is (cuDNN on the GPU).
                                 # "gemm": the pure-jnp GEMM reformulation
                                 # of ops/patch_conv.py.
                                 # "packed": space-to-depth block conv —
                                 # ONE XLA conv per layer on packed
                                 # channels (ops.patch_conv.
                                 # conv2d_block_xla) at 4x structural
                                 # FLOPs; differentiable.
                                 # "packed12": the (1, 2) half-packing at
                                 # 2x structural FLOPs.

    # --- sharding (config 5) -------------------------------------------------
    spatial_shards: int = 1      # >1: shard H across `spatial` mesh axis
    data_shards: int = 1         # >1: shard batch across `data` mesh axis

    # Named shipped weights this config pairs with (models.weights.NAMED),
    # overriding the per-method default — a preset whose quality number was
    # measured with specific weights carries them (round 5: the quality
    # preset's guided tail pairs with guided-in-loss-trained weights; tail
    # choice is part of the training contract, docs/PERFORMANCE.md @84fe805).
    # None = the method's default .npz. Explicit model_params still win.
    weights_name: Optional[str] = None
                                 # (data_shards: DP inference/serving; the
                                 # batch-sharded program compiles with no
                                 # collectives —
                                 # tests/parallel/test_dp_scaling.py)

    def __post_init__(self):
        if self.method not in _METHODS:
            raise ValueError(
                f"unknown method {self.method!r}; choose from {_METHODS}"
            )
        if self.blur_radius < 1 or self.blur_sigma <= 0:
            raise ValueError("blur_radius >= 1 and blur_sigma > 0 required")
        if not 0.0 <= self.denoise_strength <= 1.0:
            raise ValueError("denoise_strength must be in [0, 1]")
        if self.denoise_strength > 0.0 and self.denoise_sigma <= 0:
            raise ValueError("denoise_sigma must be > 0")
        from low_light_image_enhancement_tpu.ops.denoise import (
            GUIDES,
            RANGE_KERNELS,
            TAPS,
        )

        if self.denoise_kernel not in RANGE_KERNELS:
            raise ValueError(
                f"denoise_kernel must be one of {RANGE_KERNELS}: "
                f"{self.denoise_kernel!r}"
            )
        if self.denoise_guide not in GUIDES:
            raise ValueError(
                f"denoise_guide must be one of {GUIDES}: "
                f"{self.denoise_guide!r}"
            )
        if self.denoise_taps not in TAPS:
            raise ValueError(
                f"denoise_taps must be one of {TAPS}: {self.denoise_taps!r}"
            )
        if self.denoise_taps == "guided" and not 1 <= self.guided_radius <= 8:
            raise ValueError(
                f"guided_radius must be in [1, 8]: {self.guided_radius} "
                "(receptive radius 2*r sets the canvas margin; 8 is already "
                "a 32-row margin)"
            )
        if self.denoise_taps == "guided" and self.guided_eps <= 0:
            raise ValueError("guided_eps must be > 0")
        if self.conv_impl not in CONV_IMPLS:
            raise ValueError(
                f"conv_impl must be one of {CONV_IMPLS}: {self.conv_impl!r}"
            )
        if self.curve_downsample not in (1, 2, 4, 8):
            raise ValueError(
                "curve_downsample must be 1, 2, 4 or 8 (the integer-factor "
                "bilinear upsample of record and the sharded phase "
                "alignment need a small even factor)"
            )
        if self.spatial_shards < 1 or self.data_shards < 1:
            raise ValueError(
                "spatial_shards and data_shards must be >= 1: "
                f"{self.spatial_shards}, {self.data_shards}"
            )
        if self.spatial_shards > 1 and self.data_shards > 1:
            raise ValueError(
                "combined data+spatial sharding is driven via "
                "parallel.make_mesh(n_data, n_spatial) + "
                "enhance_spatial_sharded, not PipelineConfig; set only one "
                "of spatial_shards / data_shards here"
            )

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


# Named presets mirroring the five benchmark configs (BASELINE.json:6-12).
PRESETS = {
    # 1. Single LOL 600x400 image: Retinex decomposition + gamma enhance on
    #    the plain jnp graph, parity vs the reference.
    "config1_single_cpu": PipelineConfig(method="retinex", use_pallas=False),
    # 2. LOL eval-15 batched inference, fused decode->enhance->encode.
    "config2_lol_eval": PipelineConfig(method="retinex", use_pallas=True),
    # 3. Zero-DCE-style curve CNN at 512x512 batch-64.
    "config3_curve_cnn": PipelineConfig(method="curve", use_pallas=True),
    # 4. 1080p streaming enhancement with double-buffered prefetch.
    "config4_1080p_stream": PipelineConfig(method="retinex", use_pallas=True),
    # 5. 4K sharded via shard_map across the 4 devices of one host,
    #    per-shard denoise.
    "config5_4k_sharded": PipelineConfig(
        method="retinex", use_pallas=True, spatial_shards=4
    ),
    # Measured quality frontier (round 5): decomposition head trained with
    # the materialized-relit-image objective THROUGH the guided tail
    # (weights decom_relit_guided) + in-kernel guided tail at radius 4 —
    # 20.14 dB / 0.921 SSIM / dE 17.9 on eval-15 (round 4's
    # inference-tuned frontier was 19.73 / 0.918 / 18.6; training through
    # the shipping tail bought all three metrics —
    # docs/PERFORMANCE.md @84fe805 guided-in-loss round-5 section). The
    # throughput pick stays the default retinex pipeline.
    "quality": PipelineConfig(
        method="decom", denoise_taps="guided", guided_radius=4,
        weights_name="decom_relit_guided",
    ),
    # Fastest learned path that still beats every classical metric:
    # supervised FCN with the default bilateral tail (18.8 dB / 0.89).
    "quality_fast": PipelineConfig(method="fcn"),
}
