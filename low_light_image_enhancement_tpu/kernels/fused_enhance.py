"""Fused retinex kernel for the GPU (Pallas, Triton route).

One program enhances one (TH, TW) output tile of one image: u8 planar
input -> max-RGB illumination -> separable Gaussian blur -> gamma boost ->
3+3 (or 3x3) bilateral denoise -> u8. The input is read as u8 through
offset loads and the output written as u8, so no f32 plane of the chain
reaches device memory.

Triton keeps values in registers and cannot shift them, so every stencil
stage is evaluated at the offsets the next stage needs: the blurred
illumination at the 3x3 neighbourhood the denoise reads, from max-RGB
loads over a (2R+3)-square window. Edge replication comes from clamped
load indices, which reproduces the pad-once convention of ``core`` (the
image extended by edge replicas, every stage filtering across them).
Arithmetic follows ``core.enhance_core_padded`` tap for tap: the same
coefficients in the same accumulation order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from low_light_image_enhancement_tpu.config import PipelineConfig
from low_light_image_enhancement_tpu.ops.denoise import _SPATIAL_1D, _range_weight
from low_light_image_enhancement_tpu.ops.filters import gaussian_kernel_1d

# (rows, cols, warps) of one program's output tile.
DEFAULT_TILE = (8, 128, 4)


def kernel_covers(cfg: PipelineConfig) -> bool:
    """Coverage of the fused kernel: the retinex method with a bilateral
    tail, either tap layout ("sep", "full"), either guide ("luma",
    "perchannel"), either range weight, any blur radius. The guided-filter
    tail (``denoise_taps="guided"``) runs on the plain path by this rule."""
    return cfg.method == "retinex" and cfg.denoise_taps in ("sep", "full")


def _round_half_even(v):
    """``jnp.round`` for v >= 0: Triton has no round primitive."""
    f = jnp.floor(v)
    d = v - f
    odd = (f - 2.0 * jnp.floor(f * 0.5)) == 1.0
    up = (d > 0.5) | ((d == 0.5) & odd)
    return jnp.where(up, f + 1.0, f)


def _retinex_kernel(x_ref, o_ref, *, h, w, th, tw, taps, gamma, eps, inv2s2,
                    strength, kind, guide, sep, spill):
    b = pl.program_id(0)
    r0 = pl.program_id(1) * th
    c0 = pl.program_id(2) * tw
    rows = r0 + jax.lax.broadcasted_iota(jnp.int32, (th, 1), 0)
    cols = c0 + jax.lax.broadcasted_iota(jnp.int32, (1, tw), 1)
    plane = h * w

    def offsets(dy, dx):
        rr = jnp.clip(rows + dy, 0, h - 1)
        cc = jnp.clip(cols + dx, 0, w - 1)
        return rr * w + cc

    def load_u8(c, off):
        return x_ref[(b * 3 + c) * plane + off].astype(jnp.int32)

    def to_f32(v):
        return v.astype(jnp.float32) * (1.0 / 255.0)

    rad = (len(taps) - 1) // 2
    reach = rad + 1  # the denoise reads the boosted image 1 px away

    # Vertical blur of max-RGB at every column the horizontal pass needs,
    # for the three rows the denoise reads. Columns run from +reach down so
    # each horizontal sum accumulates in the reference's tap order.
    lsum = {}
    for c in range(reach, -reach - 1, -1):
        l0 = {}
        for r in range(-reach, reach + 1):
            off = offsets(r, c)
            m = jnp.maximum(jnp.maximum(load_u8(0, off), load_u8(1, off)),
                            load_u8(2, off))
            l0[r] = to_f32(m)
        for p in (-1, 0, 1):
            v = None
            for i, t in enumerate(taps):
                term = t * l0[p + rad - i]
                v = term if v is None else v + term
            for q in (-1, 0, 1):
                j = q + rad - c
                if 0 <= j < len(taps):
                    term = taps[j] * v
                    lsum[p, q] = term if (p, q) not in lsum \
                        else lsum[p, q] + term

    def boosted(p, q):
        boost = jnp.exp((gamma - 1.0) * jnp.log(jnp.clip(lsum[p, q], eps,
                                                         1.0)))
        off = offsets(p, q)
        return [jnp.clip(to_f32(load_u8(c, off)) * boost, 0.0, 1.0)
                for c in range(3)]

    def weight(d, sp):
        return sp * _range_weight(d * d, inv2s2, kind)

    if strength <= 0.0:
        out = boosted(0, 0)
    else:
        y = {(p, q): boosted(p, q) for p in (-1, 0, 1) for q in (-1, 0, 1)}
        centre = y[0, 0]

        def luma(ps):
            return (ps[0] + ps[1] + ps[2]) * (1.0 / 3.0)

        if sep:
            def pass1d(get):
                """One 3-tap pass; get(t) -> planes at shift t."""
                mid = get(0)
                if guide == "luma":
                    g0 = luma(mid)
                    accs, wacc = [None] * 3, None
                    for t in (-1, 0, 1):
                        ps = get(t)
                        wt = weight(luma(ps) - g0, _SPATIAL_1D[t + 1])
                        wacc = wt if wacc is None else wacc + wt
                        accs = [wt * s if a is None else a + wt * s
                                for a, s in zip(accs, ps)]
                    winv = 1.0 / wacc
                    return [a * winv for a in accs]
                outs = []
                for c in range(3):
                    acc = wacc = None
                    for t in (-1, 0, 1):
                        s = get(t)[c]
                        wt = weight(s - mid[c], _SPATIAL_1D[t + 1])
                        acc = wt * s if acc is None else acc + wt * s
                        wacc = wt if wacc is None else wacc + wt
                    outs.append(acc / wacc)
                return outs

            # rows pass at the three columns, then the columns pass
            f1 = {q: pass1d(lambda t, q=q: y[-t, q]) for q in (-1, 0, 1)}
            filt = pass1d(lambda t: f1[-t])
        else:
            sp2 = {(di, dj): _SPATIAL_1D[di + 1] * _SPATIAL_1D[dj + 1]
                   for di in (-1, 0, 1) for dj in (-1, 0, 1)}
            if guide == "luma":
                g0 = luma(centre)
                accs, wacc = [None] * 3, None
                for di in (-1, 0, 1):
                    for dj in (-1, 0, 1):
                        ps = y[-di, -dj]
                        wt = weight(luma(ps) - g0, sp2[di, dj])
                        wacc = wt if wacc is None else wacc + wt
                        accs = [wt * s if a is None else a + wt * s
                                for a, s in zip(accs, ps)]
                winv = 1.0 / wacc
                filt = [a * winv for a in accs]
            else:
                filt = []
                for c in range(3):
                    acc = wacc = None
                    for di in (-1, 0, 1):
                        for dj in (-1, 0, 1):
                            s = y[-di, -dj][c]
                            wt = weight(s - centre[c], sp2[di, dj])
                            acc = wt * s if acc is None else acc + wt * s
                            wacc = wt if wacc is None else wacc + wt
                    filt.append(acc / wacc)
        out = [p + strength * (f - p) for p, f in zip(centre, filt)]

    mask = (rows < h) & (cols < w)
    off = offsets(0, 0)
    dst = [(b * 3 + c) * plane + off for c in range(3)]
    if spill:
        # The interpreter's masked store rewrites masked lanes with their
        # old value, which would race the clamped duplicates of edge pixels;
        # give those lanes distinct slots past the image instead.
        lane = (rows - r0) * tw + (cols - c0)
        dst = [jnp.where(mask, d, spill + c * th * tw + lane)
               for c, d in enumerate(dst)]
    for c in range(3):
        v = _round_half_even(jnp.clip(out[c], 0.0, 1.0) * 255.0)
        v = jnp.clip(v, 0.0, 255.0).astype(jnp.int32).astype(jnp.uint8)
        pl_triton.store(o_ref.at[dst[c]], v, mask=mask)


def fused_retinex(x: jnp.ndarray, cfg: PipelineConfig,
                  interpret: bool = False, tile=DEFAULT_TILE) -> jnp.ndarray:
    """Enhance a planar u8 batch (B, 3, H, W) -> (B, 3, H, W) u8.

    ``cfg`` must satisfy :func:`kernel_covers`. ``interpret`` runs the
    Pallas interpreter (CPU tests); ``tile`` is (rows, cols, warps), rows
    and cols powers of two.
    """
    if not kernel_covers(cfg):
        raise ValueError(f"fused_retinex does not cover {cfg}")
    if x.dtype != jnp.uint8 or x.ndim != 4 or x.shape[1] != 3:
        raise ValueError(f"expected (B, 3, H, W) uint8, got {x.shape} "
                         f"{x.dtype}")
    b, _, h, w = x.shape
    th, tw, warps = tile
    n = b * 3 * h * w
    spill = n if interpret else 0
    kernel = functools.partial(
        _retinex_kernel, h=h, w=w, th=th, tw=tw,
        taps=gaussian_kernel_1d(cfg.blur_radius, cfg.blur_sigma),
        gamma=cfg.gamma, eps=cfg.illum_eps,
        inv2s2=1.0 / (2.0 * cfg.denoise_sigma * cfg.denoise_sigma),
        strength=cfg.denoise_strength, kind=cfg.denoise_kernel,
        guide=cfg.denoise_guide, sep=cfg.denoise_taps == "sep", spill=spill,
    )
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n + (3 * th * tw if spill else 0),),
                                       jnp.uint8),
        grid=(b, pl.cdiv(h, th), pl.cdiv(w, tw)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=warps,
                                                 num_stages=1),
        interpret=interpret,
        name="fused_retinex",
    )(x.reshape(-1))
    return out[:n].reshape(b, 3, h, w)
