"""Guided-filter denoise tail: the margin/halo design admits receptive
radius >= 6, and `denoise_taps="guided"` runs the He-et-al box-mean cascade
on the plain jnp path (outside the fused kernel's coverage) — single
device, tall canvases, sharded, and video.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from low_light_image_enhancement_tpu.config import (
    MARGIN,
    PipelineConfig,
    canvas_margin,
    denoise_radius,
)
from low_light_image_enhancement_tpu.core import enhance_core_padded
from low_light_image_enhancement_tpu.data.synth import synth_batch
from low_light_image_enhancement_tpu import backend
from low_light_image_enhancement_tpu.ops.filters import roll2d
from low_light_image_enhancement_tpu.ops.guided import (
    box_mean_shift,
    guided_denoise,
    guided_joint_core_shift,
)
from low_light_image_enhancement_tpu.pipeline import EnhancePipeline, pad_planar


def _wide_margin_reference(x, cfg, extra=16):
    """The same graph on a canvas with ``extra`` more replicate rows/cols:
    the interior must not move if the config's margin covers the tail."""
    m = canvas_margin(cfg)
    wide = np.asarray(enhance_core_padded(pad_planar(x, m + extra), cfg))
    h, w = x.shape[-2:]
    return wide[..., m + extra : m + extra + h, m + extra : m + extra + w]


# --------------------------------------------------------------------- #
# margin geometry
# --------------------------------------------------------------------- #

def test_canvas_margin_default_configs_unchanged():
    """Every pre-guided config must resolve to exactly MARGIN=4 — the
    round-4 parameterization may not move any existing geometry."""
    for cfg in (
        PipelineConfig(),
        PipelineConfig(method="curve", curve_downsample=4),
        PipelineConfig(method="hybrid"),
        PipelineConfig(method="fcn"),
        PipelineConfig(method="decom", denoise_taps="full"),
        PipelineConfig(denoise_strength=0.0),
    ):
        assert canvas_margin(cfg) == MARGIN


def test_canvas_margin_guided():
    assert denoise_radius(PipelineConfig(denoise_taps="guided")) == 4
    # retinex: blur 2 + guided 4 = 6 -> rounded to 8
    assert canvas_margin(PipelineConfig(denoise_taps="guided")) == 8
    # curve: no blur in the tail -> 4 fits the floor
    assert canvas_margin(
        PipelineConfig(method="curve", denoise_taps="guided")) == MARGIN
    # radius 4 -> receptive 8 (+blur 2) -> 16
    assert canvas_margin(
        PipelineConfig(denoise_taps="guided", guided_radius=4)) == 16
    # larger blur radii are now admissible too (the old hard MARGIN check)
    assert canvas_margin(PipelineConfig(blur_radius=5)) == 8


def test_guided_config_validation():
    with pytest.raises(ValueError, match="guided_radius"):
        PipelineConfig(denoise_taps="guided", guided_radius=0)
    with pytest.raises(ValueError, match="guided_eps"):
        PipelineConfig(denoise_taps="guided", guided_eps=0.0)
    with pytest.raises(ValueError, match="denoise_taps"):
        PipelineConfig(denoise_taps="box")


def test_learned_halo_covers_guided_radius():
    from low_light_image_enhancement_tpu.blocks import learned_halo

    # decom: 5-layer stack radius 5; bilateral tail -> 6 -> 8. guided
    # raises both the receptive radius (5 + 4 = 9) and the video-band
    # floor (margin 8 + radius 4 = 12) -> 16.
    assert learned_halo(PipelineConfig(method="decom")) == 8
    assert learned_halo(
        PipelineConfig(method="decom", denoise_taps="guided")) == 16
    # retinex+guided: the floor (8 + 4) drives the halo to 16, giving the
    # video carry band denoise_radius rows of slack per side
    assert learned_halo(PipelineConfig(denoise_taps="guided")) == 16
    # fcn: the dilation stack's radius dominates either way
    assert learned_halo(PipelineConfig(method="fcn")) == 72
    assert learned_halo(
        PipelineConfig(method="fcn", denoise_taps="guided")) == 72


# --------------------------------------------------------------------- #
# op-level: the shift cores agree with the integral-image public op
# --------------------------------------------------------------------- #

def test_box_mean_shift_matches_naive_wrap():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((24, 40), dtype=np.float32))
    r = 3
    got = np.asarray(box_mean_shift(x, r, roll2d))
    acc = np.zeros((24, 40), np.float64)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            acc += np.roll(np.asarray(x, np.float64), (dy, dx), (0, 1))
    np.testing.assert_allclose(got, acc / (2 * r + 1) ** 2, atol=1e-5)


def test_guided_shift_core_matches_public_op_interior():
    """On a replicate-padded canvas the wrap-shift guided core must equal
    the integral-image `guided_filter`-based op on every interior pixel
    (edge windows differ by construction: true means vs replicate pads)."""
    rng = np.random.default_rng(1)
    r = 2
    x = rng.random((3, 40, 56)).astype(np.float32)
    # luma of record differs between the op (BT.601) and the pipeline tail
    # (channel mean); compare the per-plane SELF-guided form instead, which
    # has no guide choice: op-level guided_filter(p, p) vs the shift core.
    from low_light_image_enhancement_tpu.ops.guided import (
        guided_core_shift,
        guided_filter,
    )

    pad = 3 * r  # wrap corruption + stats support clearance
    xp = jnp.asarray(np.pad(x, ((0, 0), (pad, pad), (pad, pad)), mode="edge"))
    got = np.asarray(guided_core_shift(xp[0], 1e-2, 1.0, roll2d, r))
    want = np.asarray(guided_filter(jnp.asarray(x[0]), jnp.asarray(x[0]),
                                    r, 1e-2))
    # interior = image pixels whose full 2r receptive window sees no edge
    # (there the padded-canvas windows and the true-mean windows coincide)
    inner = slice(2 * r, -(2 * r))
    np.testing.assert_allclose(
        got[pad:-pad, pad:-pad][inner, inner], want[inner, inner], atol=2e-5
    )


def test_guided_joint_core_denoises_and_preserves_edges():
    rng = np.random.default_rng(2)
    clean = np.zeros((48, 64), np.float32)
    clean[:, 32:] = 0.8  # one strong vertical edge
    noisy = np.clip(clean + rng.normal(0, 0.05, clean.shape), 0, 1)
    planes = [jnp.asarray(noisy)] * 3
    out = np.asarray(
        guided_joint_core_shift(planes, 3e-3, 1.0, roll2d, 2)[0])
    # noise drops on the flat halves...
    assert out[8:-8, 4:24].std() < 0.4 * noisy[8:-8, 4:24].std()
    # ...while the edge contrast survives
    assert (out[8:-8, 40:].mean() - out[8:-8, :24].mean()) > 0.6


# --------------------------------------------------------------------- #
# plain path, margin-8 canvas, against a wider canvas
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("guide", ["luma", "perchannel"])
@pytest.mark.parametrize("h,w", [(40, 72), (33, 47)])
def test_guided_margin_covers_tail(h, w, guide):
    cfg = PipelineConfig(denoise_taps="guided", denoise_guide=guide)
    m = canvas_margin(cfg)
    assert m == 8
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.random((2, 3, h, w), dtype=np.float32))
    got = np.asarray(enhance_core_padded(pad_planar(x, m), cfg))
    np.testing.assert_array_equal(got[..., m : m + h, m : m + w],
                                  _wide_margin_reference(x, cfg))


@pytest.mark.parametrize("radius", [2, 4])
def test_guided_two_radii_tall_canvas(radius):
    """Both radii on a tall canvas, through the pipeline (u8 in and out)."""
    from low_light_image_enhancement_tpu.ops.colorspace import (
        normalize_u8,
        quantize_u8,
    )

    cfg = PipelineConfig(denoise_taps="guided", guided_radius=radius)
    h, w = 96, 40
    lows, _ = synth_batch(1, h, w)
    got = EnhancePipeline(cfg).enhance_batch(lows)
    x = normalize_u8(jnp.asarray(np.transpose(lows, (0, 3, 1, 2))))
    want = np.transpose(np.asarray(quantize_u8(jnp.asarray(
        _wide_margin_reference(x, cfg)))), (0, 2, 3, 1))
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------- #
# end-to-end + sharded
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("method", ["retinex", "curve", "hybrid"])
def test_pipeline_guided_runs_plain_path(method):
    """The guided tail is outside the fused kernel's coverage: even a
    pipeline that asks for the interpreter runs the plain graph, and gives
    the plain graph's output."""
    lows, _ = synth_batch(2, 40, 72)
    kw = {"curve_downsample": 2} if method in ("curve", "hybrid") else {}
    cfg = PipelineConfig(method=method, denoise_taps="guided",
                         compute_dtype="float32", **kw)
    assert not backend.use_kernel(cfg, interpret=True)
    jnp_pipe = EnhancePipeline(cfg, force_jnp=True)
    pal_pipe = EnhancePipeline(cfg, pallas_interpret=True,
                               model_params=jnp_pipe.model_params)
    assert not pal_pipe._use_kernel
    np.testing.assert_array_equal(jnp_pipe.enhance_batch(lows),
                                  pal_pipe.enhance_batch(lows))


def test_sharded_guided_retinex_matches_single_device_8_shards():
    from low_light_image_enhancement_tpu.parallel import (
        enhance_spatial_sharded,
        make_mesh,
    )
    from low_light_image_enhancement_tpu.ops.colorspace import normalize_u8

    cfg = PipelineConfig(denoise_taps="guided")
    mesh = make_mesh(n_data=1, n_spatial=8)
    lows, _ = synth_batch(1, 128, 64)
    x = normalize_u8(jnp.asarray(np.transpose(lows, (0, 3, 1, 2))))
    sharded = np.asarray(enhance_spatial_sharded(x, cfg, mesh))
    single = np.asarray(EnhancePipeline(cfg, force_jnp=True)
                        .enhance_batch(lows))
    from low_light_image_enhancement_tpu.ops.colorspace import quantize_u8

    sharded_u8 = np.transpose(np.asarray(quantize_u8(jnp.asarray(sharded))),
                              (0, 2, 3, 1))
    d = np.abs(sharded_u8.astype(int) - single.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_video_guided_alpha_one_matches_stateless():
    """At alpha=1 the video step is the stateless pipeline: the guided tail
    on the video block (halo geometry, margin-8 band) against the
    pipeline's canvas. The relit gain is computed as exp(g*log L - log L)
    there and exp((g-1)*log L) here, so u8 rounding ties may differ: one
    step, on few pixels. The video step replicates the gain's margin
    columns where the pipeline blurs across them, so the outer
    ``denoise_radius`` columns are left out."""
    from low_light_image_enhancement_tpu.video import VideoEnhancer

    rng = np.random.default_rng(5)
    frames = [(rng.random((48, 64, 3)) * 255).astype(np.uint8)
              for _ in range(3)]
    cfg = PipelineConfig(denoise_taps="guided", compute_dtype="float32")
    vk = VideoEnhancer(cfg, alpha=1.0)
    pipe = EnhancePipeline(cfg)
    r = denoise_radius(cfg)
    for f in frames:
        d = np.abs(vk.process(f).astype(int) - pipe.enhance(f).astype(int))
        d = d[:, r:-r]
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
