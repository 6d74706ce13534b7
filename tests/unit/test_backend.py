"""The one backend decision (backend.use_kernel), the fused kernel's
coverage rule, and the refusal of multi-device settings a host cannot
hold."""

import jax
import pytest

from low_light_image_enhancement_tpu import backend
from low_light_image_enhancement_tpu.config import PipelineConfig
from low_light_image_enhancement_tpu.kernels import kernel_covers
from low_light_image_enhancement_tpu.pipeline import EnhancePipeline


@pytest.mark.parametrize("platform,over,kw,expected", [
    ("gpu", {}, {}, True),
    ("cpu", {}, {}, False),
    ("cpu", {}, {"interpret": True}, True),
    ("gpu", {}, {"force_jnp": True}, False),
    ("gpu", {"use_pallas": False}, {}, False),
    ("gpu", {"denoise_taps": "guided"}, {}, False),
    ("gpu", {"method": "curve"}, {}, False),
    ("cpu", {"denoise_taps": "guided"}, {"interpret": True}, False),
])
def test_use_kernel_rule(monkeypatch, platform, over, kw, expected):
    monkeypatch.setattr(backend, "platform", lambda: platform)
    assert backend.use_kernel(PipelineConfig(**over), **kw) is expected


@pytest.mark.parametrize("over,covered", [
    ({}, True),
    ({"denoise_taps": "full", "denoise_guide": "perchannel"}, True),
    ({"denoise_taps": "full"}, True),
    ({"denoise_guide": "perchannel"}, True),
    ({"denoise_kernel": "epan"}, True),
    ({"blur_radius": 3}, True),
    ({"denoise_strength": 0.0}, True),
    ({"denoise_taps": "guided"}, False),
    ({"method": "hybrid"}, False),
    ({"method": "fcn"}, False),
    ({"method": "decom"}, False),
])
def test_kernel_coverage(over, covered):
    assert kernel_covers(PipelineConfig(**over)) is covered


def test_platform_is_the_default_backend():
    assert backend.platform() == jax.default_backend() == "cpu"


def test_require_devices():
    n = len(jax.devices())
    backend.require_devices(n, "data_shards")
    with pytest.raises(ValueError, match=f"needs {n + 1} devices"):
        backend.require_devices(n + 1, "data_shards")


@pytest.mark.parametrize("field", ["data_shards", "spatial_shards"])
def test_pipeline_refuses_more_shards_than_devices(field):
    n = len(jax.devices())
    with pytest.raises(ValueError, match=field):
        EnhancePipeline(PipelineConfig(**{field: n + 1}), force_jnp=True)
