"""Classical global contrast ops: percentile autocontrast and histogram
equalization — the no-weights baselines every low-light toolkit carries.

Both are jit-compatible (static-shape scatter-add histograms) and operate on
planar images.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def autocontrast(
    x: jnp.ndarray, low_pct: float = 1.0, high_pct: float = 99.0,
    per_channel: bool = False,
) -> jnp.ndarray:
    """Percentile stretch to [0, 1] over the last two axes (or per channel
    over the last three when ``per_channel``)."""
    axes = (-2, -1) if per_channel else (-3, -2, -1)
    lo = jnp.percentile(x, low_pct, axis=axes, keepdims=True)
    hi = jnp.percentile(x, high_pct, axis=axes, keepdims=True)
    return jnp.clip((x - lo) / jnp.maximum(hi - lo, 1e-6), 0.0, 1.0)


def equalize_hist(x: jnp.ndarray, bins: int = 256) -> jnp.ndarray:
    """Global histogram equalization over the last two axes of a plane
    (..., H, W) in [0, 1], via the empirical CDF. Leading axes (batch,
    channel) are equalized independently."""
    shape = x.shape
    flat = x.reshape(-1, shape[-2] * shape[-1])

    def eq_plane(plane):
        idx = jnp.clip((plane * (bins - 1)).astype(jnp.int32), 0, bins - 1)
        hist = jnp.zeros(bins, plane.dtype).at[idx].add(1.0)
        cdf = jnp.cumsum(hist)
        cdf = cdf / cdf[-1]
        return cdf[idx]

    return jax.vmap(eq_plane)(flat).reshape(shape)


def clahe(
    x: jnp.ndarray,
    tiles: int = 8,
    clip_limit: float = 2.0,
    bins: int = 256,
) -> jnp.ndarray:
    """Contrast-limited adaptive histogram equalization over the last two
    axes of (..., H, W) planes in [0, 1].

    Static-shape formulation: per-tile histograms via one static-shape
    scatter-add, clip + uniform redistribution of the excess, per-tile CDF
    mapping tables, and a bilinear blend of the 4 surrounding tile
    mappings per pixel (four table gathers + bilinear lerp) — no
    data-dependent control flow, jit/vmap-friendly. The image is
    edge-padded up to a tile multiple and cropped back; padded replicas
    carry ZERO histogram weight, so border tiles use their true
    partial-tile counts (an edge-pixel-dominated border mapping would
    otherwise band). ``clip_limit`` is the standard
    multiple-of-uniform-bin-height ceiling (relative to each tile's own
    pixel count); large values approach plain per-tile equalization.
    """
    if tiles < 1:
        raise ValueError(f"tiles must be >= 1, got {tiles}")
    shape = x.shape
    h, w = shape[-2], shape[-1]
    th = -(-h // tiles)
    tw = -(-w // tiles)
    hp, wp = th * tiles, tw * tiles
    pad = [(0, 0)] * (x.ndim - 2) + [(0, hp - h), (0, wp - w)]
    xp = jnp.pad(x, pad, mode="edge")
    flat = xp.reshape(-1, hp, wp)
    valid = ((jnp.arange(hp) < h)[:, None]
             & (jnp.arange(wp) < w)[None, :]).astype(jnp.float32)

    def one_plane(plane):
        idx = jnp.clip((plane * (bins - 1)).astype(jnp.int32), 0, bins - 1)
        # tile id per pixel (ty * tiles + tx)
        ty = jnp.arange(hp) // th
        tx = jnp.arange(wp) // tw
        tid = ty[:, None] * tiles + tx[None, :]
        nt = tiles * tiles
        hist = jnp.zeros((nt, bins), jnp.float32).at[
            tid.reshape(-1), idx.reshape(-1)
        ].add(valid.reshape(-1))
        # contrast limit: clip each bin at clip_limit * uniform height
        # (of this tile's true count) and spread the clipped excess
        # uniformly (single pass — the standard approximation). Floored
        # at one count (OpenCV-style): when count << bins the unfloored
        # limit drops below 1 and clips EVERY occupied bin, flattening
        # small tiles to an identity ramp.
        count = jnp.sum(hist, axis=1, keepdims=True)
        limit = jnp.maximum(clip_limit * count / bins, 1.0)
        excess = jnp.sum(jnp.maximum(hist - limit, 0.0), axis=1,
                         keepdims=True)
        hist = jnp.minimum(hist, limit) + excess / bins
        cdf = jnp.cumsum(hist, axis=1)
        # a tile can be ALL padding (tiny images: tiles*ceil(h/tiles) can
        # overshoot h by a full tile); its LUT is still blended into real
        # border pixels, so give it the identity ramp instead of 0/0
        ramp = jnp.arange(bins, dtype=jnp.float32) / (bins - 1)
        cdf = jnp.where(cdf[:, -1:] > 0,
                        cdf / jnp.maximum(cdf[:, -1:], 1e-9),
                        ramp[None, :])
        # bilinear blend of the 4 neighboring tile mappings, weighted by
        # distance to tile CENTERS (clamped at the border tiles)
        cy = (jnp.arange(hp) - th / 2.0 + 0.5) / th
        cx = (jnp.arange(wp) - tw / 2.0 + 0.5) / tw
        y0 = jnp.clip(jnp.floor(cy).astype(jnp.int32), 0, tiles - 1)
        x0 = jnp.clip(jnp.floor(cx).astype(jnp.int32), 0, tiles - 1)
        y1 = jnp.minimum(y0 + 1, tiles - 1)
        x1 = jnp.minimum(x0 + 1, tiles - 1)
        wy = jnp.clip(cy - y0, 0.0, 1.0)[:, None]
        wx = jnp.clip(cx - x0, 0.0, 1.0)[None, :]

        def lut(tyi, txi):
            t = (tyi[:, None] * tiles + txi[None, :])
            return cdf[t, idx]

        v00 = lut(y0, x0)
        v01 = lut(y0, x1)
        v10 = lut(y1, x0)
        v11 = lut(y1, x1)
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        return top * (1 - wy) + bot * wy

    out = jax.vmap(one_plane)(flat).reshape(xp.shape)
    return out[..., :h, :w].astype(x.dtype)
