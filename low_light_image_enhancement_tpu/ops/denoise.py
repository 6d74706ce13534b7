"""Bilateral-lite 3x3 denoise expressed as 9 shifted taps.

Spatial weights are the separable [1/4, 1/2, 1/4] binomial; range weights
are a decreasing function of the per-channel value difference, selectable:

* ``"exp"``  — Gaussian ``exp(-d^2 / 2 sigma^2)`` (the classic bilateral,
  the default).
* ``"epan"`` — squared Epanechnikov ``max(0, 1 - d^2 / 6 sigma^2)^2``: same
  sigma scale and monotone shape, ~4 cheap ALU ops instead of a
  transcendental. An option for backends where transcendentals dominate.

The structure (9 static shifts, fixed accumulation order) is mirrored
exactly by the fused kernel (``kernels.fused_enhance``), which evaluates
the same taps from offset loads.

Spec: BASELINE.json north_star ("fused denoise") and config 5 per-shard
denoise (BASELINE.json:11).
"""

from __future__ import annotations

import jax.numpy as jnp

from low_light_image_enhancement_tpu.ops.filters import roll2d, shift2d

_SPATIAL_1D = (0.25, 0.5, 0.25)

RANGE_KERNELS = ("exp", "epan")


def _range_weight(d2, inv2s2, kind: str):
    if kind == "exp":
        return jnp.exp(-d2 * inv2s2)
    if kind == "epan":
        # (1 - t/3)^2 tracks exp(-t) closely on t in [0, 3] (0.44 vs 0.37
        # at t=1, 0.11 vs 0.14 at t=2) and cuts off where the Gaussian is
        # ~0.05 — near-identical smoothing without a transcendental.
        u = jnp.maximum(1.0 - d2 * (inv2s2 * (1.0 / 3.0)), 0.0)
        return u * u
    raise ValueError(f"range kernel must be one of {RANGE_KERNELS}: {kind!r}")


def bilateral_core(x, inv2s2, strength, shift_fn, kind: str = "exp"):
    """3x3 bilateral filter as 9 shifted taps over the last two axes.

    ``shift_fn(x, dy, dx)`` supplies boundary semantics; the Pallas kernel
    passes a roll-based shift, the public op passes edge-replicate.
    ``kind`` selects the range weight (module docstring).
    """
    acc = jnp.zeros_like(x)
    wacc = jnp.zeros_like(x)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            s = shift_fn(x, di, dj)
            d = s - x
            w = (_SPATIAL_1D[di + 1] * _SPATIAL_1D[dj + 1]) * _range_weight(
                d * d, inv2s2, kind
            )
            acc = acc + w * s
            wacc = wacc + w
    filtered = acc / wacc
    return x + strength * (filtered - x)


def bilateral_joint_core(planes, inv2s2, strength, shift_fn,
                         kind: str = "exp"):
    """Luma-guided JOINT bilateral over a sequence of channel planes: range
    weights come from the channel-mean luminance guide and are shared by
    every channel (the classic cross/joint bilateral). vs the per-channel
    form this computes one weight plane per tap instead of three — ~40%
    fewer plane sweeps in the fused kernel — and keeps chroma smoothing
    aligned with luminance edges (no per-channel color fringing).

    Returns the filtered planes, same order. Tap order matches
    ``bilateral_core`` exactly so kernel parity tests cover both guides.
    """
    luma = (planes[0] + planes[1] + planes[2]) * (1.0 / 3.0)
    accs = [jnp.zeros_like(p) for p in planes]
    wacc = jnp.zeros_like(luma)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            g = shift_fn(luma, di, dj)
            d = g - luma
            w = (_SPATIAL_1D[di + 1] * _SPATIAL_1D[dj + 1]) * _range_weight(
                d * d, inv2s2, kind
            )
            wacc = wacc + w
            for k, p in enumerate(planes):
                accs[k] = accs[k] + w * shift_fn(p, di, dj)
    winv = 1.0 / wacc
    return [p + strength * (acc * winv - p)
            for p, acc in zip(planes, accs)]


def bilateral_sep_core(x, inv2s2, strength, shift_fn, kind: str = "exp"):
    """Separable bilateral approximation: a 3-tap bilateral pass along rows,
    then along columns of the row-filtered result — 6 shifted taps instead
    of 9. The bilateral is only approximately separable (diagonal neighbors
    are weighted through the intermediate), but at radius 1 the difference
    is far below the denoise strength's blend."""
    f = x
    for dy, dx in ((1, 0), (0, 1)):
        acc = jnp.zeros_like(f)
        wacc = jnp.zeros_like(f)
        for t in (-1, 0, 1):
            s = shift_fn(f, t * dy, t * dx)
            d = s - f
            w = _SPATIAL_1D[t + 1] * _range_weight(d * d, inv2s2, kind)
            acc = acc + w * s
            wacc = wacc + w
        f = acc / wacc
    return x + strength * (f - x)


def bilateral_sep_joint_core(planes, inv2s2, strength, shift_fn,
                             kind: str = "exp"):
    """Separable + luma-guided joint bilateral: 2 passes, one weight plane
    per tap from the (pass-local) luminance guide. The cheapest tap
    structure offered."""
    outs = list(planes)
    for dy, dx in ((1, 0), (0, 1)):
        luma = (outs[0] + outs[1] + outs[2]) * (1.0 / 3.0)
        accs = [jnp.zeros_like(p) for p in outs]
        wacc = jnp.zeros_like(luma)
        for t in (-1, 0, 1):
            g = shift_fn(luma, t * dy, t * dx)
            d = g - luma
            w = _SPATIAL_1D[t + 1] * _range_weight(d * d, inv2s2, kind)
            wacc = wacc + w
            for k, p in enumerate(outs):
                accs[k] = accs[k] + w * shift_fn(p, t * dy, t * dx)
        winv = 1.0 / wacc
        outs = [acc * winv for acc in accs]
    return [p + strength * (o - p) for p, o in zip(planes, outs)]


GUIDES = ("perchannel", "luma")
TAPS = ("full", "sep", "guided")


def plane_cores(guide: str, taps: str, guided_radius: int = 2,
                guided_eps: float = 3e-3):
    """(single-plane core, joint core) pair for a (guide, taps) choice.
    Every core
    has the uniform signature ``core(x_or_planes, inv2s2, strength,
    shift_fn, kind)``; the guided cores (taps="guided") bind their radius
    and eps here and ignore the bilateral's ``inv2s2``/``kind``."""
    if guide not in GUIDES:
        raise ValueError(f"denoise guide must be one of {GUIDES}: {guide!r}")
    if taps not in TAPS:
        raise ValueError(f"denoise taps must be one of {TAPS}: {taps!r}")
    if taps == "guided":
        from low_light_image_enhancement_tpu.ops.guided import (
            guided_core_shift,
            guided_joint_core_shift,
        )

        def core1(x, inv2s2, strength, shift_fn, kind="exp"):
            return guided_core_shift(x, guided_eps, strength, shift_fn,
                                     guided_radius)

        def corej(planes, inv2s2, strength, shift_fn, kind="exp"):
            return guided_joint_core_shift(planes, guided_eps, strength,
                                           shift_fn, guided_radius)

        return core1, corej
    if taps == "full":
        return bilateral_core, bilateral_joint_core
    return bilateral_sep_core, bilateral_sep_joint_core


def denoise_planar(x, inv2s2, strength, shift_fn, kind: str = "exp",
                   guide: str = "perchannel", taps: str = "full",
                   guided_radius: int = 2, guided_eps: float = 3e-3):
    """Dispatch on (guide, taps) for a planar (..., 3, H, W) array. The
    shared entry used by the pipeline/core/video jnp paths."""
    core1, corej = plane_cores(guide, taps, guided_radius, guided_eps)
    if guide == "perchannel":
        return core1(x, inv2s2, strength, shift_fn, kind)
    planes = [x[..., c, :, :] for c in range(3)]
    return jnp.stack(
        corej(planes, inv2s2, strength, shift_fn, kind),
        axis=-3,
    )


def bilateral_denoise(
    x: jnp.ndarray,
    sigma_range: float = 0.12,
    strength: float = 0.5,
    mode: str = "clamp",
    kind: str = "exp",
    guide: str = "perchannel",
    taps: str = "full",
) -> jnp.ndarray:
    """Edge-preserving 3x3 filter over the last two axes, blended by
    ``strength`` (0 = passthrough). Works on any planar layout
    (``guide="luma"`` requires a channel axis at -3).

    mode="clamp": edge-replicate boundary (public-op semantics).
    mode="wrap":  circular boundary for pre-padded inputs (pipeline core).
    kind: range-weight kernel, "exp" or "epan" (module docstring).
    guide: "perchannel" weights, or "luma" for the joint bilateral.
    taps: "full" 3x3 (9 taps) or "sep" separable approximation (3+3 taps,
      ``bilateral_sep_core``).
    """
    if strength == 0.0:
        return x
    shift_fn = shift2d if mode == "clamp" else roll2d
    inv2s2 = 1.0 / (2.0 * sigma_range * sigma_range)
    return denoise_planar(x, inv2s2, strength, shift_fn, kind, guide, taps)
