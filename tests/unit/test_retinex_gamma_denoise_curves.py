import numpy as np
import jax.numpy as jnp

from low_light_image_enhancement_tpu.ops import (
    apply_curves,
    bilateral_denoise,
    gamma_correct,
    gaussian_blur,
    illumination_map,
    reflectance,
    retinex_enhance,
)


def _rand_rgb(seed=0, shape=(3, 16, 24)):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.random(shape, dtype=np.float32))


# ---------------------------------------------------------------- retinex ---

def test_illumination_is_blurred_max():
    x = _rand_rgb()
    want = gaussian_blur(jnp.max(x, axis=0), 2, 1.0)
    got = illumination_map(x, 2, 1.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=0)


def test_reflectance_division():
    x = _rand_rgb(1)
    l = jnp.max(x, axis=0)
    r = np.asarray(reflectance(x, l, eps=1e-3))
    want = np.asarray(x) / np.maximum(np.asarray(l), 1e-3)[None]
    np.testing.assert_allclose(r, want, atol=1e-7)


def test_retinex_enhance_brightens_dark_images():
    x = _rand_rgb(2) * 0.2  # dark
    y = np.asarray(retinex_enhance(x, gamma=0.45))
    assert y.mean() > np.asarray(x).mean() * 1.5
    assert y.min() >= 0.0 and y.max() <= 1.0


def test_retinex_enhance_near_identity_on_bright():
    x = jnp.clip(_rand_rgb(3) * 0.2 + 0.8, 0, 1)
    y = np.asarray(retinex_enhance(x, gamma=0.45))
    assert np.abs(y - np.asarray(x)).mean() < 0.12


def test_retinex_enhance_equals_explicit_decomposition():
    # fused form x * L**(g-1) == reflectance(x, L) * L**g
    x = _rand_rgb(4) * 0.5 + 0.1
    g, eps = 0.45, 1e-3
    l = jnp.clip(illumination_map(x, 2, 1.0), eps, 1.0)
    explicit = reflectance(x, l, eps=eps) * (l ** g)[None]
    fused = retinex_enhance(x, gamma=g, eps=eps)
    np.testing.assert_allclose(
        np.asarray(fused), np.clip(np.asarray(explicit), 0, 1), atol=1e-4
    )


# ------------------------------------------------------------------ gamma ---

def test_gamma_correct():
    x = jnp.asarray([0.0, 0.25, 1.0], jnp.float32)
    y = np.asarray(gamma_correct(x, 0.5))
    np.testing.assert_allclose(y, [0.0, 0.5, 1.0], atol=1e-6)


# ---------------------------------------------------------------- denoise ---

def test_denoise_strength_zero_is_identity():
    x = _rand_rgb(5)
    y = bilateral_denoise(x, strength=0.0)
    np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


def test_denoise_preserves_constant():
    x = jnp.full((3, 12, 16), 0.6, jnp.float32)
    y = np.asarray(bilateral_denoise(x, strength=1.0))
    np.testing.assert_allclose(y, 0.6, atol=1e-6)


def test_denoise_reduces_noise_keeps_edges():
    rng = np.random.default_rng(6)
    clean = np.zeros((1, 32, 32), np.float32)
    clean[:, :, 16:] = 0.8  # vertical step edge
    noisy = np.clip(clean + rng.normal(0, 0.03, clean.shape), 0, 1).astype(
        np.float32
    )
    out = np.asarray(bilateral_denoise(jnp.asarray(noisy), strength=1.0))
    # noise reduced on flat regions
    assert out[:, 4:28, 2:12].std() < noisy[:, 4:28, 2:12].std() * 0.8
    # edge magnitude preserved within 15%
    edge = out[:, 16, 17] - out[:, 16, 14]
    assert edge > 0.8 * 0.85


def test_denoise_epan_kind_close_to_exp():
    """The squared-Epanechnikov range weight tracks the Gaussian closely:
    same sigma scale, near-identical smoothing (ops/denoise.py module
    docstring)."""
    x = _rand_rgb(7)
    y_exp = np.asarray(bilateral_denoise(x, strength=1.0, kind="exp"))
    y_epa = np.asarray(bilateral_denoise(x, strength=1.0, kind="epan"))
    assert not np.array_equal(y_exp, y_epa)  # genuinely different weights
    assert np.abs(y_exp - y_epa).max() < 0.03  # but near-identical output


def test_denoise_epan_preserves_constant_and_rejects_unknown():
    import pytest

    x = jnp.full((3, 12, 16), 0.4, jnp.float32)
    y = np.asarray(bilateral_denoise(x, strength=1.0, kind="epan"))
    np.testing.assert_allclose(y, 0.4, atol=1e-6)
    with pytest.raises(ValueError, match="range kernel"):
        bilateral_denoise(x, strength=1.0, kind="gauss")


def test_denoise_luma_guide_preserves_constant_and_reduces_noise():
    x = jnp.full((3, 12, 16), 0.5, jnp.float32)
    y = np.asarray(bilateral_denoise(x, strength=1.0, guide="luma"))
    np.testing.assert_allclose(y, 0.5, atol=1e-6)

    rng = np.random.default_rng(11)
    clean = np.full((3, 32, 32), 0.4, np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.03, clean.shape), 0, 1).astype(
        np.float32
    )
    out = np.asarray(bilateral_denoise(jnp.asarray(noisy), strength=1.0,
                                       guide="luma"))
    assert out[:, 4:28, 4:28].std() < noisy[:, 4:28, 4:28].std() * 0.8


def test_denoise_luma_guide_shares_weights_across_channels():
    """With a step edge only in one channel, the luma guide must smooth all
    channels with the SAME weights: the flat channels stay flat and the
    per-channel and joint outputs genuinely differ at the edge."""
    x = np.full((3, 16, 16), 0.5, np.float32)
    x[0, :, 8:] = 0.9  # red-only edge
    xj = jnp.asarray(x)
    per = np.asarray(bilateral_denoise(xj, strength=1.0, guide="perchannel"))
    joint = np.asarray(bilateral_denoise(xj, strength=1.0, guide="luma"))
    assert not np.allclose(per, joint)
    np.testing.assert_allclose(joint[1], 0.5, atol=1e-6)  # flat stays flat


def test_denoise_sep_taps_close_to_full_and_reduces_noise():
    """The separable 3+3-tap approximation must track the full 3x3 bilateral
    closely on natural-ish data and still denoise (the default tap layout
    — ops/denoise.py bilateral_sep_core)."""
    rng = np.random.default_rng(21)
    clean = np.zeros((3, 32, 32), np.float32)
    clean[:, :, 16:] = 0.7
    noisy = np.clip(clean + rng.normal(0, 0.03, clean.shape), 0, 1).astype(
        np.float32
    )
    full = np.asarray(bilateral_denoise(jnp.asarray(noisy), strength=1.0,
                                        taps="full"))
    sep = np.asarray(bilateral_denoise(jnp.asarray(noisy), strength=1.0,
                                       taps="sep"))
    assert not np.array_equal(full, sep)
    assert np.abs(full - sep).max() < 0.02
    assert sep[:, 4:28, 2:12].std() < noisy[:, 4:28, 2:12].std() * 0.8
    # edge preserved
    assert (sep[:, 16, 17] - sep[:, 16, 14]).min() > 0.7 * 0.85


def test_denoise_sep_luma_combination_runs():
    x = jnp.full((3, 16, 24), 0.3, jnp.float32)
    y = np.asarray(bilateral_denoise(x, strength=1.0, taps="sep",
                                     guide="luma"))
    np.testing.assert_allclose(y, 0.3, atol=1e-6)


def test_config_rejects_unknown_denoise_taps():
    import pytest

    from low_light_image_enhancement_tpu.config import PipelineConfig

    with pytest.raises(ValueError, match="denoise_taps"):
        PipelineConfig(denoise_taps="diag")


def test_config_rejects_unknown_denoise_guide():
    import pytest

    from low_light_image_enhancement_tpu.config import PipelineConfig

    with pytest.raises(ValueError, match="denoise_guide"):
        PipelineConfig(denoise_guide="chroma")


def test_config_rejects_unknown_denoise_kernel():
    import pytest

    from low_light_image_enhancement_tpu.config import PipelineConfig

    with pytest.raises(ValueError, match="denoise_kernel"):
        PipelineConfig(denoise_kernel="nope")


# ----------------------------------------------------------------- curves ---

def test_curves_zero_alpha_identity():
    x = _rand_rgb(7)
    a = jnp.zeros((8, 3, 16, 24), jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(apply_curves(x, a)), np.asarray(x)
    )


def test_curves_positive_alpha_brightens_and_stays_bounded():
    x = _rand_rgb(8)
    a = jnp.full((8, 3, 16, 24), 0.5, jnp.float32)
    y = np.asarray(apply_curves(x, a))
    assert (y >= np.asarray(x) - 1e-6).all()
    assert y.min() >= 0.0 and y.max() <= 1.0 + 1e-6


def test_curves_matches_numpy_oracle():
    rng = np.random.default_rng(9)
    x = rng.random((3, 8, 8), dtype=np.float32)
    a = (rng.random((4, 3, 8, 8), dtype=np.float32) - 0.5) * 2
    want = x.copy()
    for i in range(4):
        want = want + a[i] * want * (1 - want)
    got = np.asarray(apply_curves(jnp.asarray(x), jnp.asarray(a)))
    np.testing.assert_allclose(got, want, atol=1e-6)
