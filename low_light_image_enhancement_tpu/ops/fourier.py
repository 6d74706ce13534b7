"""Fourier-domain enhancement (cf. "Enhancing RAW-to-sRGB with Decoupled
Style Structure in Fourier Domain", PAPERS.md:7).

The luminance of a low-light image lives mostly in the FFT *amplitude*
spectrum while structure lives in *phase*; scaling amplitude brightens
without disturbing edges. ``fourier_amplitude_boost`` implements that
decoupled adjustment as a pure-jnp op (XLA lowers jnp.fft to the
backend's FFT). Useful both as a standalone enhancement and as a feature-space block
for learned models.
"""

from __future__ import annotations

import jax.numpy as jnp


def fourier_amplitude_boost(
    x: jnp.ndarray, factor: float = 1.5, preserve_dc: bool = False
) -> jnp.ndarray:
    """Scale the FFT amplitude spectrum of the last two axes by ``factor``
    while keeping phase; clips back to [0, 1].

    ``preserve_dc=True`` keeps the DC term (mean brightness) and scales only
    the AC amplitudes (contrast boost instead of brightness boost).
    """
    spec = jnp.fft.rfft2(x)
    amp = jnp.abs(spec)
    phase = jnp.angle(spec)
    new_amp = amp * factor
    if preserve_dc:
        dc = amp[..., :1, :1]
        new_amp = new_amp.at[..., :1, :1].set(dc)
    out = jnp.fft.irfft2(new_amp * jnp.exp(1j * phase), s=x.shape[-2:])
    return jnp.clip(out, 0.0, 1.0)


def amplitude_phase_swap(
    content: jnp.ndarray, style: jnp.ndarray
) -> jnp.ndarray:
    """Recombine ``content``'s phase (structure) with ``style``'s amplitude
    (illumination/color statistics) — the Fourier style-structure decoupling
    primitive from PAPERS.md:7."""
    c_spec = jnp.fft.rfft2(content)
    s_spec = jnp.fft.rfft2(style)
    out = jnp.fft.irfft2(
        jnp.abs(s_spec) * jnp.exp(1j * jnp.angle(c_spec)),
        s=content.shape[-2:],
    )
    return jnp.clip(out, 0.0, 1.0)
