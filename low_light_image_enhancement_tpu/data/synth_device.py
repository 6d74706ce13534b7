"""Device-side synthetic low-light pair generation (jit-compatible).

Same construction as ``data.synth`` (smooth random color field + texture,
smooth illumination, sensor noise) but built from ``jax.random`` inside jit,
so training loops can generate batches on the device — zero host->device
transfer per step, the cheapest way to keep a fast device fed with
synthetic data.

Not bit-identical to the numpy generator (different RNG); statistically the
same distribution.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _smooth_field(key: jax.Array, b: int, h: int, w: int, c: int,
                  grid: int) -> jnp.ndarray:
    coarse = jax.random.uniform(key, (b, grid, grid, c))
    return jax.image.resize(coarse, (b, h, w, c), method="bilinear")


def synth_pair_batch(
    key: jax.Array, batch: int, h: int, w: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (low, high) planar f32 (batch, 3, h, w) in [0, 1].

    Same hardened degradation recipe as ``data.synth.synth_pair``: log-
    uniform exposure, smooth illumination field, per-channel color cast,
    heteroscedastic (shot + read) sensor noise."""
    k_base, k_tex, k_fine, k_lvl, k_illum, k_cast, k_rd, k_sh, k_noise = (
        jax.random.split(key, 9)
    )
    base = _smooth_field(k_base, batch, h, w, 3, grid=6)
    texture = _smooth_field(k_tex, batch, h, w, 3, grid=24) - 0.5
    fine = _smooth_field(k_fine, batch, h, w, 3, grid=48) - 0.5
    gt = jnp.clip(0.15 + 0.72 * base + 0.22 * texture + 0.10 * fine,
                  0.02, 0.98)

    level = jnp.exp(jax.random.uniform(
        k_lvl, (batch, 1, 1, 1),
        minval=jnp.log(0.03), maxval=jnp.log(0.45)))
    illum = (0.4 + 0.6 * _smooth_field(k_illum, batch, h, w, 1, grid=4)) \
        * level
    cast = 1.0 + jax.random.uniform(k_cast, (batch, 1, 1, 3),
                                    minval=-0.25, maxval=0.25)
    cast = cast / jnp.mean(cast, axis=-1, keepdims=True)
    signal = gt * illum * cast
    read = jax.random.uniform(k_rd, (batch, 1, 1, 1),
                              minval=0.004, maxval=0.015)
    shot = jax.random.uniform(k_sh, (batch, 1, 1, 1),
                              minval=0.0005, maxval=0.003)
    sigma = jnp.sqrt(read * read + shot * jnp.clip(signal, 0.0, 1.0))
    low = jnp.clip(
        signal + sigma * jax.random.normal(k_noise, (batch, h, w, 3)),
        0.0, 1.0,
    )

    to_planar = lambda x: jnp.transpose(x, (0, 3, 1, 2))
    return to_planar(low), to_planar(gt)


def synth_batch_iter(batch: int, h: int, w: int, seed: int = 0):
    """Infinite iterator of device-resident (low, high) batches; the
    generation is jitted and fused with nothing else (callers fold it into
    their own jit by using ``synth_pair_batch`` directly if they want)."""
    gen = jax.jit(lambda k: synth_pair_batch(k, batch, h, w),
                  static_argnums=())
    key = jax.random.PRNGKey(seed)
    while True:
        key, sub = jax.random.split(key)
        yield gen(sub)
