"""Parity + adversarial tests for the retinex video step
(``video.video_step``, plain jnp), against an independent in-test oracle.

Two contracts pinned here:

1. **Math parity**: the step reproduces an in-test jnp oracle of the
   documented EMA algebra — normalize -> max-RGB illumination -> separable
   blur -> per-pixel EMA (negative carry = not yet initialized) ->
   temporally-relit gain ``exp(gamma*log(l_mix) - log(l_now))`` -> margin
   column replication -> denoise -> quantize — on every consumed pixel, for
   fresh, initialized and per-stream-mixed carries, u8 and f32 io.

2. **Consumed-band isolation** (the exactness argument of
   ``parallel.video_sharded``): carry rows OUTSIDE the interior band
   [halo - MARGIN, halo + rows + MARGIN) never reach an output — poisoning
   them (huge values AND the negative sentinel) changes neither the output
   frames nor the carry inside the band, single-device and sharded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from low_light_image_enhancement_tpu.blocks import (
    block_geometry,
    learned_halo,
    replicate_margin_cols,
)
from low_light_image_enhancement_tpu.config import MARGIN, PipelineConfig
from low_light_image_enhancement_tpu.ops.colorspace import (
    normalize_u8,
    quantize_u8,
)
from low_light_image_enhancement_tpu.ops.filters import roll2d, separable_blur
from low_light_image_enhancement_tpu.video import (
    VideoEnhancer,
    _denoise_tail,
    video_step,
)


def _oracle_ema(xp, carry, cfg, alpha, img_w):
    """The documented EMA video algebra on a whole block, written out
    independently of video.video_step (negative carry = uninitialized)."""
    u8_io = xp.dtype == jnp.uint8
    xf = normalize_u8(xp) if u8_io else xp
    l_now = separable_blur(jnp.max(xf, axis=-3), cfg.blur_radius,
                           cfg.blur_sigma, roll2d)
    l_mix = jnp.where(carry < 0.0, l_now,
                      alpha * l_now + (1.0 - alpha) * carry)
    gain = jnp.exp(cfg.gamma * jnp.log(jnp.clip(l_mix, cfg.illum_eps, 1.0))
                   - jnp.log(jnp.clip(l_now, cfg.illum_eps, 1.0)))
    gain = replicate_margin_cols(gain, img_w)
    y = _denoise_tail(jnp.clip(xf * gain[:, None], 0.0, 1.0), cfg)
    return (quantize_u8(y) if u8_io else y), l_mix


def _block(b, h, w, cfg, seed, u8):
    """(b, 3, HB, WB) edge-padded block, as video._make_step builds it."""
    rng = np.random.default_rng(seed)
    x = rng.random((b, 3, h, w), dtype=np.float32)
    if u8:
        x = (x * 255).round().astype(np.uint8)
    halo = learned_halo(cfg)
    h_core, wp = block_geometry(cfg, h, w)
    xb = np.pad(x, ((0, 0), (0, 0), (halo, halo + h_core - h),
                    (MARGIN, wp - w - MARGIN)), mode="edge")
    return jnp.asarray(xb), halo


@pytest.mark.parametrize("carry_mode", ["fresh", "init", "mixed"])
@pytest.mark.parametrize("u8", [True, False])
def test_fused_retinex_ema_matches_jnp_oracle(carry_mode, u8):
    cfg = PipelineConfig()
    h, w, alpha = 40, 72, 0.3
    xb, halo = _block(2, h, w, cfg, seed=7, u8=u8)
    rng = np.random.default_rng(8)
    carry = rng.random((2,) + xb.shape[-2:], dtype=np.float32) * 0.5 + 0.05
    flag = {"fresh": [False, False], "init": [True, True],
            "mixed": [False, True]}[carry_mode]  # mixed: stream 0 was reset
    (_, got_lmix), got = video_step(
        (jnp.asarray(flag), jnp.asarray(carry)), xb, cfg, alpha, h=h, w=w)
    oracle_carry = np.where(np.asarray(flag)[:, None, None], carry, -1.0)
    want, want_lmix = _oracle_ema(xb, jnp.asarray(oracle_carry), cfg, alpha,
                                  w)
    m = MARGIN
    g = np.asarray(got)[..., :h, m : m + w]
    wv = np.asarray(want)[..., halo : halo + h, m : m + w]
    if u8:
        d = np.abs(g.astype(int) - wv.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
    else:
        np.testing.assert_allclose(g, wv, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(got_lmix)[..., halo : halo + h, m : m + w],
        np.asarray(want_lmix)[..., halo : halo + h, m : m + w], atol=1e-6,
    )


def test_alpha_one_reduces_to_stateless_illumination():
    """alpha=1 ignores the carry entirely: a garbage (but positive) carry
    produces the same frame as a fresh stream."""
    cfg = PipelineConfig()
    xb, _ = _block(1, 40, 72, cfg, seed=3, u8=True)
    junk = (jnp.ones((1,), bool), jnp.full((1,) + xb.shape[-2:], 0.77))
    fresh = (jnp.zeros((1,), bool), jnp.zeros((1,) + xb.shape[-2:]))
    _, a = video_step(junk, xb, cfg, 1.0, h=40, w=72)
    _, b = video_step(fresh, xb, cfg, 1.0, h=40, w=72)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _poison(carry_np, lo, hi, value):
    """Poison carry rows outside the consumed band [lo, hi)."""
    c = carry_np.copy()
    c[..., :lo, :] = value
    c[..., hi:, :] = value
    return c


@pytest.mark.parametrize("poison_value", [1e6, -5.0])
def test_video_step_ignores_carry_outside_consumed_band(poison_value):
    """Carry rows outside [halo - MARGIN, halo + rows + MARGIN) are dead:
    poisoning them (huge positive, and the negative sentinel that would
    flip those pixels to 'uninitialized' if read) changes neither the
    output frames nor the in-band carry, over multiple frames."""
    cfg = PipelineConfig(compute_dtype="float32")
    halo = learned_halo(cfg)
    rng = np.random.default_rng(11)
    frames = [(rng.random((40, 64, 3)) * 255).astype(np.uint8)
              for _ in range(3)]

    ve_a = VideoEnhancer(cfg, alpha=0.3)
    ve_b = VideoEnhancer(cfg, alpha=0.3)
    oa = ve_a.process(frames[0])
    ob = ve_b.process(frames[0])
    np.testing.assert_array_equal(oa, ob)

    # poison ve_b's carry rows outside the consumed band
    flag, carry = ve_b._state
    rows = np.asarray(carry).shape[-2] - 2 * halo  # block rows
    lo, hi = halo - MARGIN, halo + rows + MARGIN
    assert lo > 0, "test needs a nonempty outside-band region"
    ve_b._state = (flag,
                   jnp.asarray(_poison(np.asarray(carry), lo, hi,
                                       poison_value)))
    for f in frames[1:]:
        oa = ve_a.process(f)
        ob = ve_b.process(f)
        np.testing.assert_array_equal(oa, ob)
    np.testing.assert_array_equal(np.asarray(ve_a._state[1])[lo:hi],
                                  np.asarray(ve_b._state[1])[lo:hi])


def test_sharded_video_ignores_carry_outside_consumed_band():
    """Same poison argument per shard: each shard's outside-band carry rows
    (its halo overlap region minus the MARGIN-consumed edge) are dead."""
    from low_light_image_enhancement_tpu.parallel import (
        SpatialShardedVideoEnhancer,
        make_mesh,
    )

    cfg = PipelineConfig(compute_dtype="float32")
    halo = learned_halo(cfg)
    mesh = make_mesh(n_data=1, n_spatial=2)
    rng = np.random.default_rng(12)
    frames = [(rng.random((96, 64, 3)) * 255).astype(np.uint8)
              for _ in range(3)]

    sa = SpatialShardedVideoEnhancer(mesh, cfg, alpha=0.3)
    sb = SpatialShardedVideoEnhancer(mesh, cfg, alpha=0.3)
    np.testing.assert_array_equal(sa.process(frames[0]),
                                  sb.process(frames[0]))
    flag, carry = sb._state  # (n_shards, canvas_rows, wp)
    rows = np.asarray(carry).shape[-2] - 2 * halo
    lo, hi = halo - MARGIN, halo + rows + MARGIN
    sb._state = (flag, jnp.asarray(_poison(np.asarray(carry), lo, hi, 1e6)))
    for f in frames[1:]:
        np.testing.assert_array_equal(sa.process(f), sb.process(f))
    np.testing.assert_array_equal(np.asarray(sa._state[1])[:, lo:hi],
                                  np.asarray(sb._state[1])[:, lo:hi])


def test_traced_alpha_jits():
    """alpha may be traced: jitting video_step over it compiles one program
    for every alpha, and the result matches the static-alpha step."""
    cfg = PipelineConfig(compute_dtype="float32")
    halo = learned_halo(cfg)
    h, w = 40, 64
    h_core, wp = block_geometry(cfg, h, w)
    xb = jnp.asarray(np.random.default_rng(5).integers(
        0, 255, (3, h_core + 2 * halo, wp), dtype=np.uint8))
    state = (jnp.ones((), bool), jnp.full((h_core + 2 * halo, wp), 0.3))

    def step(state, xb, alpha):
        return video_step(state, xb, cfg, alpha, None, h, w)

    (_, c_traced), out_traced = jax.jit(step)(state, xb, 0.3)
    (_, c_static), out_static = step(state, xb, 0.3)
    assert out_traced.shape[-2] == h_core
    assert c_traced.shape == state[1].shape
    d = np.abs(np.asarray(out_traced, int) - np.asarray(out_static, int))
    assert d.max() <= 1
