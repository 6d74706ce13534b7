"""Patch-GEMM convolution: GEMM-shaped reformulation of small-channel 3x3
convs.

XLA lowers a 3x3 conv with C=24..32 channels to per-tap matmuls of shape
(M, C) @ (C, C). The reformulation here computes each 2x2 block of output
pixels as ONE GEMM row over its 4x4 input patch:

- M = number of 2x2 output blocks (B * H/2 * W/2).
- K = 16 * Cin (the 4x4 patch, all input channels).
- N = 4 * Cout (four output pixels * channels).

at the cost of a 16/9 FLOP inflation (the densified patch weights carry
structural zeros: each output pixel only consumes 9 of the 16 patch
pixels).

Activations live in space-to-depth *packed* layout (B, H/2, W/2, 4C),
feature index = phase-major (p * C + c, p = py*2+px), through the whole conv
stack: the patch gather for the next layer reads phase slices of the packed
previous output directly, so images are packed once on entry and unpacked
once at exit.

Dilated layers (the fcn stack) cannot be densified this way for even
dilation (taps at +-d preserve pixel phase, so there is no cross-phase
mixing); they use the classic im2col GEMM instead (K = 9*Cin, N = Cout).
`conv2d_gemm` picks the right form per (dilation, parity).

Everything here is pure jnp and directly jit-able. Numerics: contraction
order differs from lax.conv, so outputs match to f32 rounding (~1e-6), not
bit-exactly; see tests/unit/test_patch_conv.py.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

# Patch row/col offsets, in order, relative to the output block origin.
_OFFS = (-1, 0, 1, 2)


def space_to_depth(
    x: jnp.ndarray, block: Tuple[int, int] = (2, 2)
) -> jnp.ndarray:
    """(B, H, W, C) -> (B, H/bh, W/bw, bh*bw*C), feature index =
    (py*bw+px)*C + c. ``block=(1, 2)`` is the half-packing used in the
    mid-batch conv regime (2x lane fill at 2x structural FLOPs)."""
    bh, bw = block
    b, h, w, c = x.shape
    if h % bh or w % bw:
        raise ValueError(f"space_to_depth{block} needs H%{bh}==W%{bw}==0; "
                         f"got {h}x{w}")
    x = x.reshape(b, h // bh, bh, w // bw, bw, c)
    return jnp.transpose(x, (0, 1, 3, 2, 4, 5)).reshape(
        b, h // bh, w // bw, bh * bw * c
    )


def depth_to_space(
    x: jnp.ndarray, block: Tuple[int, int] = (2, 2)
) -> jnp.ndarray:
    """Inverse of :func:`space_to_depth`."""
    bh, bw = block
    b, h2, w2, cp = x.shape
    c = cp // (bh * bw)
    x = x.reshape(b, h2, w2, bh, bw, c)
    return jnp.transpose(x, (0, 1, 3, 2, 4, 5)).reshape(
        b, bh * h2, bw * w2, c
    )


def pack_patch_weights(
    w: jnp.ndarray, groups: Sequence[int] = ()
) -> jnp.ndarray:
    """(3, 3, Cin, Cout) conv weights -> (4, 4*Cin, 4*Cout) patch-GEMM slabs.

    Slab ``i`` multiplies the patch row at offset ``_OFFS[i]``; its row index
    is (ox, cin) with ox over ``_OFFS`` — matching `_patch_slab`'s layout —
    and its column index is (qy*2+qx)*Cout + cout (phase-major, matching the
    packed output layout). ``groups``: channel-group sizes of the *input*
    when it is a packed-concat of several tensors (e.g. the curve CNN's skip
    concats) — the row layout then iterates (ox, group, cin-within-group),
    matching `jnp.concatenate([slab(a), slab(b)], -1)`. Structural zeros fill
    taps outside the 3x3 window.
    """
    w = jnp.asarray(w)  # jnp throughout: packing may run on traced params
    _, _, cin, cout = w.shape
    groups = tuple(groups) or (cin,)
    assert sum(groups) == cin, (groups, cin)
    zeros = jnp.zeros((cin, cout), w.dtype)
    rows_per_oy = []
    for oy in _OFFS:
        blocks = []  # one (cin, 4*cout) block per ox
        for ox in _OFFS:
            cols = []
            for qy in range(2):
                for qx in range(2):
                    dy, dx = oy - qy, ox - qx
                    cols.append(
                        w[dy + 1, dx + 1]
                        if dy in (-1, 0, 1) and dx in (-1, 0, 1)
                        else zeros
                    )
            blocks.append(jnp.concatenate(cols, axis=1))
        rows_per_oy.append(jnp.concatenate(blocks, axis=0))
    # pure concat/stack construction: a handful of fused XLA ops when the
    # packing runs on traced params inside a jit (vs 64 scatter updates)
    return jnp.stack(rows_per_oy)


def pack_bias(b: jnp.ndarray, phases: int = 4) -> jnp.ndarray:
    """(Cout,) -> (phases*Cout,): bias replicated per output phase."""
    return jnp.tile(jnp.asarray(b), phases)


def _phase_plane(xp: jnp.ndarray, p: int, c: int) -> jnp.ndarray:
    """Phase-p channel slice of a packed tensor (..., 4c) -> (..., c)."""
    return xp[..., p * c : (p + 1) * c]


def _shift_mask(
    plane: jnp.ndarray, by: int, bx: int
) -> jnp.ndarray:
    """plane[..., Y+by, X+bx, :] with zeros outside — conv SAME semantics.

    ``plane`` is (B, H2, W2, C); by/bx in {-1, 0, 1}.
    """
    if by or bx:
        plane = jnp.roll(plane, (-by, -bx), axis=(1, 2))
    h2, w2 = plane.shape[1], plane.shape[2]
    if by:
        rows = jnp.arange(h2).reshape(1, h2, 1, 1)
        edge = h2 - 1 if by > 0 else 0
        plane = jnp.where(rows == edge, 0.0, plane)
    if bx:
        cols = jnp.arange(w2).reshape(1, 1, w2, 1)
        edge = w2 - 1 if bx > 0 else 0
        plane = jnp.where(cols == edge, 0.0, plane)
    return plane


def patch_slab(
    xp: jnp.ndarray, oy: int, groups: Sequence[int]
) -> jnp.ndarray:
    """Gather the patch row at offset ``oy`` from packed input(s).

    ``xp``: packed (B, H2, W2, 4*Cin) where Cin = sum(groups) and the
    feature layout is [group-blocks, each phase-major] (a concat of packed
    tensors). Returns (B, H2, W2, 4*Cin) with layout (ox, group, cin).
    """
    by, py = divmod(oy, 2)
    cum = np.cumsum((0,) + tuple(groups))
    slabs = []
    for ox in _OFFS:
        bx, px = divmod(ox, 2)
        p = py * 2 + px
        for g, c in enumerate(groups):
            base = 4 * cum[g]
            plane = xp[..., base + p * c : base + (p + 1) * c]
            slabs.append(_shift_mask(plane, by, bx))
    return jnp.concatenate(slabs, axis=-1)


def conv2d_patch_gemm(
    xp: jnp.ndarray,
    wp: jnp.ndarray,
    bp: jnp.ndarray,
    compute_dtype,
    groups: Sequence[int] = (),
) -> jnp.ndarray:
    """Packed 3x3 SAME conv as four accumulated GEMMs.

    xp: (B, H2, W2, 4*Cin) packed input (phase-major per group).
    wp: (4, 4*Cin, 4*Cout) from `pack_patch_weights`.
    bp: (4*Cout,) from `pack_bias`.
    Returns packed (B, H2, W2, 4*Cout) in ``compute_dtype``.
    """
    cin4 = xp.shape[-1]
    groups = tuple(groups) or (cin4 // 4,)
    acc = None
    for i, oy in enumerate(_OFFS):
        slab = patch_slab(xp, oy, groups).astype(compute_dtype)
        term = jnp.einsum(
            "bhwk,kn->bhwn",
            slab,
            wp[i].astype(compute_dtype),
            preferred_element_type=jnp.float32,
        )
        acc = term if acc is None else acc + term
    return (acc + bp.astype(jnp.float32)).astype(compute_dtype)


# --------------------------------------------------------------------- #
# im2col GEMM (dilated layers: fcn). K = 9*Cin, N = Cout.
# --------------------------------------------------------------------- #


def pack_im2col_weights(w: jnp.ndarray) -> jnp.ndarray:
    """(3, 3, Cin, Cout) -> (9*Cin, Cout), row layout (dy, dx, cin)."""
    w = jnp.asarray(w)
    return w.reshape(-1, w.shape[-1])


def _shift_mask_full(x: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """x[..., Y+dy, X+dx, :] with zeros outside (arbitrary |dy|, |dx|)."""
    if dy or dx:
        x = jnp.roll(x, (-dy, -dx), axis=(1, 2))
    h, w = x.shape[1], x.shape[2]
    if dy:
        rows = jnp.arange(h).reshape(1, h, 1, 1)
        ok = (rows < h - dy) if dy > 0 else (rows >= -dy)
        x = jnp.where(ok, x, 0.0)
    if dx:
        cols = jnp.arange(w).reshape(1, 1, w, 1)
        ok = (cols < w - dx) if dx > 0 else (cols >= -dx)
        x = jnp.where(ok, x, 0.0)
    return x


def conv2d_im2col_gemm(
    x: jnp.ndarray,
    w9: jnp.ndarray,
    b: jnp.ndarray,
    compute_dtype,
    dilation: int = 1,
) -> jnp.ndarray:
    """Unpacked 3x3 SAME conv (dilation-aware) as 3 accumulated GEMMs.

    x: (B, H, W, Cin); w9: (9*Cin, Cout) from `pack_im2col_weights`.
    One GEMM per patch row keeps the im2col buffer at 3*Cin columns.
    """
    cin = x.shape[-1]
    cout = w9.shape[-1]
    acc = None
    for r, dy in enumerate((-dilation, 0, dilation)):
        slab = jnp.concatenate(
            [
                _shift_mask_full(x, dy, dx)
                for dx in (-dilation, 0, dilation)
            ],
            axis=-1,
        ).astype(compute_dtype)
        wrow = w9[3 * r * cin : 3 * (r + 1) * cin].astype(compute_dtype)
        term = jnp.einsum(
            "bhwk,kn->bhwn", slab, wrow, preferred_element_type=jnp.float32
        )
        acc = term if acc is None else acc + term
    return (acc + b.astype(jnp.float32)).astype(compute_dtype)


# --------------------------------------------------------------------- #
# Block conv: the dense-9-tap packed form as ONE XLA conv ("packed" impl).
# --------------------------------------------------------------------- #


def _axis_tap(t: int, p: int, q: int, block: int, dilation: int):
    """Original-weight tap index along one axis for packed tap ``t`` and
    (in, out) phases ``p, q`` under ``block``-packing with ``dilation`` —
    or None when that (t, p, q) combination is structurally zero.

    block == 1: the axis is unpacked; the packed conv runs rhs_dilation =
    ``dilation`` and tap t maps straight through (phases are trivial).
    block > 1, dilation == 1: cross-phase routing — original offset
    block*t + p - q must land in the 3x3 window.
    block > 1, dilation % block == 0: taps preserve phase (offsets are
    multiples of the block) and the packed conv runs rhs_dilation =
    ``dilation // block``.
    """
    if block == 1:
        return t
    if dilation == 1:
        d = block * t + p - q
        return d if d in (-1, 0, 1) else None
    if dilation % block == 0:
        return t if p == q else None
    raise ValueError(
        f"dilation {dilation} incompatible with block {block}: need 1, "
        f"block==1, or dilation % block == 0"
    )


def pack_block_conv_weights(
    w: jnp.ndarray,
    groups: Sequence[int] = (),
    dilation: int = 1,
    block: Tuple[int, int] = (2, 2),
) -> jnp.ndarray:
    """(3, 3, Cin, Cout) -> (3, 3, P*Cin, P*Cout) space-to-depth conv
    weights, P = block_h * block_w phases.

    The dense-9-tap reformulation expressed as a plain 3x3 conv over PACKED
    activations: tap (by, bx) is a
    block shift, and the per-tap (P*Cin, P*Cout) matrix carries the
    (in-phase -> out-phase) routing as weight structure (per-axis rules in
    :func:`_axis_tap`; even dilation d runs packed rhs_dilation d/block).
    Channel width rises from Cin to P*Cin at a P-times structural-FLOP
    inflation; the (1,2) half-packing costs 2x FLOPs. Row layout matches the packed
    activation layout ([group][phase][ci]); columns are output-phase-major,
    matching :func:`depth_to_space`. Differentiable (pure slice/concat
    packing + one lax.conv).
    """
    w = jnp.asarray(w)
    _, _, cin, cout = w.shape
    bh, bw = block
    nP = bh * bw
    groups = tuple(groups) or (cin,)
    assert sum(groups) == cin, (groups, cin)
    cum = np.cumsum((0,) + groups)
    taps = []
    for by in (-1, 0, 1):
        row = []
        for bx in (-1, 0, 1):
            rblocks = []
            for g, cg in enumerate(groups):
                sl = slice(int(cum[g]), int(cum[g]) + cg)
                for p in range(nP):
                    py, px = divmod(p, bw)
                    cols = []
                    for q in range(nP):
                        qy, qx = divmod(q, bw)
                        dy = _axis_tap(by, py, qy, bh, dilation)
                        dx = _axis_tap(bx, px, qx, bw, dilation)
                        cols.append(
                            w[dy + 1, dx + 1, sl]
                            if dy is not None and dx is not None
                            else jnp.zeros((cg, cout), w.dtype)
                        )
                    rblocks.append(jnp.concatenate(cols, axis=1))
            row.append(jnp.concatenate(rblocks, axis=0))
        taps.append(jnp.stack(row))
    return jnp.stack(taps)


def conv2d_block_xla(
    xp: jnp.ndarray,
    wk: jnp.ndarray,
    b: jnp.ndarray,
    compute_dtype,
    step=1,
) -> jnp.ndarray:
    """Packed 3x3 SAME conv as one XLA conv on space-to-depth lanes.

    xp: (B, Hb, Wb, P*Cin) packed activations; wk: (3, 3, P*Cin, P*Cout)
    from :func:`pack_block_conv_weights`; step: packed rhs_dilation — 1 for
    dilation 1, d//block per axis for even original dilation d (int or
    (step_y, step_x)). SAME zero padding on blocks reproduces the original
    conv's SAME semantics exactly (out-of-window pixels carry structural
    zero weights). Returns packed (B, Hb, Wb, P*Cout).
    """
    from jax import lax

    from low_light_image_enhancement_tpu.models.layers import precision_for

    steps = (step, step) if isinstance(step, int) else tuple(step)
    phases = wk.shape[3] // b.shape[0]
    y = lax.conv_general_dilated(
        xp.astype(compute_dtype),
        wk.astype(compute_dtype),
        window_strides=(1, 1),
        padding="SAME",
        rhs_dilation=steps,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=precision_for(compute_dtype),
    )
    return y + pack_bias(b, phases).astype(compute_dtype)


def even_image(h: int, w: int) -> Tuple[int, int]:
    """Round (h, w) up to even — the packed layout's only shape demand."""
    return h + (h % 2), w + (w % 2)
