"""Block-form learned-method graph: one semantics for single-device & sharded.

The learned methods (curve / hybrid / fcn / decom) run on a *row block*: the
image rows a device owns plus ``learned_halo(cfg)`` replicate-or-neighbor rows
on each side. The same function — ``enhance_learned_block`` — is the
single-device pipeline body (halo rows come from ``jnp.pad(mode='edge')``) and
the shard_map per-device body (halo rows arrive from the neighbours via
``parallel.halo.halo_pad_local``), so spatially-sharded output matches
single-device output *by construction*: the only inputs that differ are the
halo rows, and the halo exchange reproduces exactly the rows edge-padding
would produce (BASELINE.json config 5; SURVEY.md §5 long-context row).

Boundary semantics (canonical, alignment-independent): the net consumes the
image extended by ``MARGIN`` replicate rows/cols on each side and *zeros
beyond* — every value a consumed output can reach is either real data, one of
those MARGIN replicas, or a defined zero. Conv SAME zero-padding at the block
edge coincides with the mask, so block height/width alignment padding can
never leak into the output (SURVEY.md §7 hard part (a): the 0.1 dB budget
dies in padding edges).

The whole block, denoise tail included, is plain ``jax.numpy``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from low_light_image_enhancement_tpu.config import (
    MARGIN,
    PipelineConfig,
    canvas_margin,
    denoise_radius,
)
from low_light_image_enhancement_tpu.core import illumination_boost
from low_light_image_enhancement_tpu.ops.curves import apply_curves


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cnn_radius(cfg: PipelineConfig) -> int:
    """Receptive-field radius (pixels at full resolution) of the learned net
    selected by ``cfg.method``; 0 for methods with no net."""
    if cfg.method in ("curve", "hybrid"):
        ds = cfg.curve_downsample
        # 7 stacked 3x3 convs -> radius 7 at CNN resolution. With the CNN at
        # 1/ds resolution: 7*ds for the convs, plus ~ds each for the
        # antialiased bilinear down/up resample supports.
        return 7 if ds == 1 else 9 * ds
    if cfg.method == "fcn":
        from low_light_image_enhancement_tpu.models.fcn import _dilations

        return sum(_dilations(7))  # 3x3 convs: radius = sum of dilations
    if cfg.method == "decom":
        return 5  # five 3x3 convs
    return 0


def learned_halo(cfg: PipelineConfig) -> int:
    """Replicate/neighbour halo rows per side for the block graph: the full
    receptive radius of everything between block input and consumed output,
    rounded to a multiple of 8 (of 8 * curve_downsample for the curve nets,
    so shard-local resample grids coincide with the single-device grid)."""
    r = cnn_radius(cfg)
    if cfg.method == "hybrid":
        r += cfg.blur_radius  # boost runs before the CNN sees the block
    r += denoise_radius(cfg)  # bilateral (1) or guided (2*r) tail
    granule = 8 * cfg.curve_downsample if cfg.method in ("curve", "hybrid") \
        else 8
    # Floor at margin + denoise radius: the video carry's consumed band
    # spans [halo - margin, halo + rows + margin) while consumers (denoise
    # taps of cropped outputs) read within denoise_radius of the owned
    # rows — halo - margin must cover that reach (the consumed-band
    # argument of parallel.video_sharded).
    floor = canvas_margin(cfg) + denoise_radius(cfg)
    return _round_up(max(r, floor), granule)


def single_block_halo(cfg: PipelineConfig) -> int:
    """Halo rows for an UNSHARDED block (the whole image is one block) —
    smaller than ``learned_halo`` yet bit-identical, for any weights.

    Derivation (first-divergence analysis, verified bit-exact in
    tests/unit/test_single_block_halo.py): ``_mask_extent`` zeroes the input
    beyond image + MARGIN on *both* canvases, and conv SAME zero padding
    equals those masked zeros, so **layer-1 activations are identical** on
    every row both canvases share. Divergence (``relu(bias)`` cascades the
    big canvas carries beyond the small canvas's edge) first appears in
    layer-2 outputs at the small canvas's edge rows and propagates inward by
    one dilation per remaining layer — reach = ``sum(dilations[2:])`` rows
    from the canvas edge. Output rows at depth >= halo are untouched iff
    halo > reach (+1 for the bilateral tail). For the 7x(3x3, dil 1) curve
    CNN at 1/ds resolution the reach is 6 lowres rows < the 8-lowres-row
    granule halo; decom's 5-layer stack reaches 4 < 8. fcn's divergence
    reach is its layer-2..7 dilation sum (2+4+8+16+32+1 = 63) + 1 bilateral
    row = 64 < the 72-row full halo (which also counts layer 1's dilation) —
    a small but free canvas cut.

    Hybrid additionally needs ``blur_radius`` real replicate rows beyond the
    MARGIN band: the boost's wrap-roll blur must read true edge replicas (not
    wrapped opposite-edge rows) everywhere the post-boost mask keeps values.
    ``learned_halo`` (the full receptive radius) remains required whenever a
    block must carry REAL neighbor content across a shard boundary.
    """
    if cfg.denoise_taps == "guided":
        # The first-divergence derivation below assumes the tail reads at
        # most 1 row past the divergence reach; the guided cascade reads
        # 2*guided_radius. Rather than re-derive the minimal canvas per
        # radius, guided configs use the always-safe full receptive halo
        # (they are quality-oriented; the canvas cut is a small perf nicety).
        return learned_halo(cfg)
    if cfg.method == "fcn":
        from low_light_image_enhancement_tpu.models.fcn import _dilations

        return _round_up(sum(_dilations(7)[1:]) + denoise_radius(cfg), 8)
    r = canvas_margin(cfg)
    if cfg.method == "hybrid":
        r += cfg.blur_radius
    granule = 8 * cfg.curve_downsample if cfg.method in ("curve", "hybrid") \
        else 8
    return _round_up(r, granule)


def resolve_conv_impl(cfg: PipelineConfig) -> PipelineConfig:
    """Resolve ``conv_impl="auto"`` to a concrete lowering: XLA's own
    convolution (cuDNN on the GPU). ``packed``, ``packed12`` and ``gemm``
    stay explicit choices."""
    if cfg.conv_impl == "auto":
        return cfg.replace(conv_impl="xla")
    return cfg


def _mask_extent(
    y: jnp.ndarray, row0, h: int, w: int, m: int = MARGIN
) -> jnp.ndarray:
    """Zero everything outside the image extended by ``m`` (the config's
    canvas margin) replicate rows/cols. Block row l <-> image row row0 + l
    (row0 may be traced: shard_map passes axis_index * rows_per_shard -
    halo); block col c <-> image col c - m."""
    hb, wb = y.shape[-2], y.shape[-1]
    g = row0 + jax.lax.broadcasted_iota(jnp.int32, (hb, 1), 0)
    row_ok = (g >= -m) & (g < h + m)
    col_ok = jax.lax.broadcasted_iota(jnp.int32, (1, wb), 1) < w + 2 * m
    return jnp.where(row_ok & col_ok, y, 0.0)


def replicate_margin_cols(y: jnp.ndarray, w: int,
                          m: int = MARGIN) -> jnp.ndarray:
    """Restore the MARGIN column-replica invariant after a wrap-roll stage:
    the blurred illumination (and hence the hybrid boost) wraps
    ``blur_radius`` columns at the canvas edges, so canvas cols [0, MARGIN)
    and [MARGIN+w, WB) would otherwise carry opposite-edge content into the
    CNN's receptive field (they sit within cnn_radius of consumed outputs).
    Replaces them with replicas of the boosted image cols 0 / w-1 — exactly
    the values the module invariant promises. The fused curve kernel applies
    the same two selects in-kernel (`fused_enhance._kreplicate_cols`)."""
    wb = y.shape[-1]
    col = jax.lax.broadcasted_iota(jnp.int32, (1, wb), 1)
    left = y[..., :, m:m + 1]
    right = y[..., :, m + w - 1:m + w]
    y = jnp.where(col < m, left, y)
    return jnp.where(col >= m + w, right, y)


def _curve_maps_lowres(
    cnn_in: jnp.ndarray, cfg: PipelineConfig, params: Dict[str, Any],
) -> jnp.ndarray:
    """Estimate LE-curve maps on the (masked) block at 1/ds resolution
    (near-lossless FLOP cut: the maps are smooth by the TV training loss).
    Returns (..., n_iter, 3, HB/ds, WB/ds) — NOT upsampled."""
    from low_light_image_enhancement_tpu.models.curve_cnn import (
        apply_curve_cnn,
        apply_curve_cnn_gemm,
        apply_curve_cnn_packed,
    )

    ds = cfg.curve_downsample
    if ds > 1:
        *lead, hb, wb = cnn_in.shape
        if hb % ds or wb % ds:
            raise ValueError(
                f"block {hb}x{wb} not divisible by curve_downsample={ds}"
            )
        cnn_in = jax.image.resize(
            cnn_in, (*lead, hb // ds, wb // ds), method="bilinear"
        )
    apply = {"gemm": apply_curve_cnn_gemm,
             "packed": apply_curve_cnn_packed,
             "packed12": partial(apply_curve_cnn_packed, block=(1, 2)),
             }.get(cfg.conv_impl, apply_curve_cnn)
    return apply(
        params, cnn_in, n_iter=cfg.curve_iters,
        compute_dtype=jnp.dtype(cfg.compute_dtype),
    )


def _curve_maps(
    cnn_in: jnp.ndarray, cfg: PipelineConfig, params: Dict[str, Any],
) -> jnp.ndarray:
    """Full-resolution LE-curve maps: low-res estimate + the integer-factor
    bilinear upsample of record (``ops.filters.upsample_int``, cols then
    rows)."""
    from low_light_image_enhancement_tpu.ops.filters import (
        shift2d,
        upsample_int,
    )

    maps = _curve_maps_lowres(cnn_in, cfg, params)
    ds = cfg.curve_downsample
    if ds > 1:
        maps = upsample_int(maps, ds, axis=-1, shift_fn=shift2d)
        maps = upsample_int(maps, ds, axis=-2, shift_fn=shift2d)
    return maps


def enhance_learned_block(
    xb: jnp.ndarray,
    cfg: PipelineConfig,
    model_params: Optional[Dict[str, Any]],
    row0,
    h: int,
    w: int,
    pre_boosted: Optional[jnp.ndarray] = None,
    halo: Optional[int] = None,
) -> jnp.ndarray:
    """Learned-method enhance on one halo'd row block.

    Args:
      xb: (B, 3, HB, WB) block — f32 in [0, 1], or uint8 (sharded halos
        then move u8 rows at 1/4 the bytes; the block converts at its own
        boundary); HB = owned rows + 2 * halo; WB from ``block_geometry``,
        with MARGIN replicate cols before the image's col 0. Halo rows are
        neighbor rows (sharded) or edge replicas (single device / global
        edges) — same values either way.
      row0: image-row index of block row 0 (may be a traced scalar).
      h, w: true image extent, for the zero-mask beyond MARGIN.
      pre_boosted: (hybrid only) an externally computed illumination-boosted
        block — e.g. the temporally-EMA'd boost of ``video.video_step`` —
        used in place of the internal ``illumination_boost``.
      halo: rows per side above/below the owned rows; defaults to
        ``learned_halo(cfg)`` (the sharded contract). The single-device
        pipeline passes ``single_block_halo(cfg)`` — semantics are identical
        (the input mask zeroes beyond image + MARGIN either way) on a
        smaller canvas.

    Returns (B, 3, HB - 2*halo, WB): enhanced owned rows, cols uncropped,
    dtype matching ``xb``.
    """
    from low_light_image_enhancement_tpu.ops.colorspace import (
        normalize_u8,
        quantize_u8,
    )

    cfg = resolve_conv_impl(cfg)
    m = canvas_margin(cfg)
    if halo is None:
        halo = learned_halo(cfg)
    rows = xb.shape[-2] - 2 * halo
    u8_io = xb.dtype == jnp.uint8
    xf = normalize_u8(xb) if u8_io else xb
    y = xf

    if cfg.method == "hybrid":
        # Boost first (Zero-DCE-on-boosted convention). Roll-wrap row
        # corruption stays >= cnn_radius+1 from consumed outputs by the halo
        # sizing; the corrupted MARGIN *columns* are re-replicated below
        # (replicate_margin_cols) so the CNN never sees wrapped content.
        y = pre_boosted if pre_boosted is not None \
            else illumination_boost(y, cfg)
        y = replicate_margin_cols(y, w, m)

    cnn_in = _mask_extent(y if cfg.method == "hybrid" else xf, row0, h, w, m)

    if cfg.method in ("curve", "hybrid"):
        maps = _curve_maps(cnn_in, cfg, model_params)
        y = jnp.clip(apply_curves(y, maps), 0.0, 1.0)
        if u8_io and cfg.denoise_strength <= 0.0:
            return quantize_u8(y[..., halo : halo + rows, :])
    elif cfg.method == "fcn":
        from low_light_image_enhancement_tpu.models.fcn import (
            apply_fcn,
            apply_fcn_gemm,
            apply_fcn_packed,
        )

        apply = {"gemm": apply_fcn_gemm,
                 "packed": apply_fcn_packed,
                 "packed12": partial(apply_fcn_packed, block=(1, 2)),
                 }.get(cfg.conv_impl, apply_fcn)
        y = apply(model_params, cnn_in,
                  compute_dtype=jnp.dtype(cfg.compute_dtype))
        y = jnp.clip(y, 0.0, 1.0)
    elif cfg.method == "decom":
        from low_light_image_enhancement_tpu.models.decom import (
            apply_decom_net,
            apply_decom_net_gemm,
            apply_decom_net_packed,
        )

        apply = {"gemm": apply_decom_net_gemm,
                 "packed": apply_decom_net_packed,
                 "packed12": partial(apply_decom_net_packed, block=(1, 2)),
                 }.get(cfg.conv_impl, apply_decom_net)
        r, l = apply(
            model_params, cnn_in,
            compute_dtype=jnp.dtype(cfg.compute_dtype),
        )
        l_boost = jnp.clip(l, cfg.illum_eps, 1.0) ** cfg.decom_gamma
        y = jnp.clip(r * l_boost, 0.0, 1.0)
    else:
        raise ValueError(
            f"enhance_learned_block: method {cfg.method!r} is not a learned "
            "method (retinex has its own path)"
        )

    if cfg.denoise_strength <= 0.0:
        out = y[..., halo : halo + rows, :]
        return quantize_u8(out) if u8_io else out

    from low_light_image_enhancement_tpu.ops.denoise import denoise_planar
    from low_light_image_enhancement_tpu.ops.filters import roll2d

    inv2s2 = 1.0 / (2.0 * cfg.denoise_sigma * cfg.denoise_sigma)
    y = denoise_planar(y, inv2s2, cfg.denoise_strength, roll2d,
                       cfg.denoise_kernel, cfg.denoise_guide,
                       cfg.denoise_taps, cfg.guided_radius, cfg.guided_eps)
    out = jnp.clip(y, 0.0, 1.0)[..., halo : halo + rows, :]
    return quantize_u8(out) if u8_io else out


def block_geometry(cfg: PipelineConfig, h: int, w: int, n_shards: int = 1):
    """(rows_per_shard, padded_w) for the block graph: rows rounded so every
    shard owns the same 8- and resample-aligned row count; width padded to a
    multiple of 128 with MARGIN cols before the image origin. The learned
    nets see zeros beyond image + MARGIN, and the resample's boundary sits
    at the padded width, so this width is part of the learned methods'
    numerics."""
    halo = learned_halo(cfg)
    granule = 8
    if cfg.method in ("curve", "hybrid"):
        granule = 8 * cfg.curve_downsample
    hl = _round_up(int(math.ceil(h / n_shards)), granule)
    if n_shards > 1 and hl < halo:
        raise ValueError(
            f"{n_shards} spatial shards of a {h}-row image give {hl} "
            f"rows/shard, below the {halo}-row receptive-field halo of "
            f"method={cfg.method!r}; use fewer shards or larger frames"
        )
    wp = _round_up(w + 2 * canvas_margin(cfg), 128)
    return hl, wp
