"""Sanity tests for the analytic per-image cost model (utils.roofline)."""

import pytest

from low_light_image_enhancement_tpu.config import PipelineConfig
from low_light_image_enhancement_tpu.utils import roofline
from low_light_image_enhancement_tpu.utils.roofline import (
    achieved,
    pipeline_cost,
    train_step_cost,
)


def test_retinex_is_pixel_work_and_minimal_io():
    cfg = PipelineConfig()
    c = pipeline_cost(cfg, 400, 600)
    assert c.conv_flops == 0.0          # no convs on the classical path
    assert c.mem_bytes == 6 * 400 * 600  # u8 in + u8 out, nothing else
    assert c.pixel_flops > 50 * 400 * 600  # blur + gain + bilateral per px


def test_costs_scale_with_area():
    cfg = PipelineConfig(method="fcn")
    a = pipeline_cost(cfg, 200, 300)
    b = pipeline_cost(cfg, 400, 600)
    for f in ("conv_flops", "pixel_flops", "mem_bytes"):
        assert getattr(b, f) == pytest.approx(4 * getattr(a, f), rel=1e-6)


def test_curve_downsample_cuts_conv_flops_quadratically():
    c1 = pipeline_cost(PipelineConfig(method="curve", curve_downsample=1),
                       400, 600)
    c4 = pipeline_cost(PipelineConfig(method="curve", curve_downsample=4),
                       400, 600)
    assert c4.conv_flops == pytest.approx(c1.conv_flops / 16, rel=1e-6)
    assert c4.mem_bytes < c1.mem_bytes


def test_bf16_halves_activation_traffic():
    bf = pipeline_cost(PipelineConfig(method="fcn"), 400, 600)
    f32 = pipeline_cost(
        PipelineConfig(method="fcn", compute_dtype="float32"), 400, 600)
    io = 6 * 400 * 600
    assert f32.mem_bytes - io == pytest.approx(2 * (bf.mem_bytes - io))


def test_fcn_conv_flops_match_hand_count():
    # 7 3x3 layers: (3->24) + 6x(24->24), + 1x1 (24->3), per pixel x2 (FMA)
    per_px = 2 * 9 * (3 * 24 + 6 * 24 * 24) + 2 * 24 * 3
    c = pipeline_cost(PipelineConfig(method="fcn"), 400, 600)
    assert c.conv_flops == per_px * 400 * 600


def test_achieved_rates_from_counts():
    c = pipeline_cost(PipelineConfig(), 400, 600)
    r = achieved(c, images_per_sec=45_640.0)
    assert r["achieved_mem_gbps"] == pytest.approx(
        6 * 400 * 600 * 45_640 / 1e9, rel=1e-9)
    assert r["achieved_conv_tflops"] == 0.0
    assert all(isinstance(v, float) for v in r.values())


@pytest.mark.parametrize("method", ["retinex", "curve", "hybrid", "fcn",
                                    "decom"])
def test_every_method_has_a_model(method):
    c = pipeline_cost(PipelineConfig(method=method), 400, 600)
    assert c.pixel_flops > 0 and c.mem_bytes >= 6 * 400 * 600
    assert (c.conv_flops > 0) == (method != "retinex")


def test_no_device_peak_is_assumed():
    """Shares of a peak belong to the benchmark's peak table, keyed by
    device kind; this module carries counts only."""
    names = [n for n in dir(roofline) if n.isupper() and not n.startswith("_")]
    assert names == [], names
    assert "roofline_bound" not in achieved(
        pipeline_cost(PipelineConfig(), 8, 8), 1.0)


def test_train_step_cost():
    c = train_step_cost(32, 8, 512, remat=True)
    c_nr = train_step_cost(32, 8, 512, remat=False)
    # remat = one extra forward pass of conv FLOPs, more activation traffic
    assert c.conv_flops == pytest.approx(c_nr.conv_flops * 4 / 3)
    assert c.mem_bytes > c_nr.mem_bytes  # recompute re-materializes acts
    # conv FLOPs: 4 passes x 2*9*sum(cin*cout)*px
    pairs = 3 * 32 + 3 * 32 * 32 + 2 * 64 * 32 + 64 * 24
    assert c.conv_flops == pytest.approx(4 * 2 * 9 * pairs * 512 * 512)
