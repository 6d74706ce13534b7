"""conv_impl resolution (blocks.resolve_conv_impl): "auto" is XLA's own
convolution on every backend; the packed and GEMM lowerings are explicit
choices only; the retired kernel lowerings are refused."""

import pytest

from low_light_image_enhancement_tpu import blocks
from low_light_image_enhancement_tpu.config import CONV_IMPLS, PipelineConfig


@pytest.mark.parametrize("method", ["retinex", "curve", "hybrid", "fcn",
                                    "decom"])
def test_auto_resolves_to_xla(method):
    cfg = PipelineConfig(method=method, conv_impl="auto")
    assert blocks.resolve_conv_impl(cfg).conv_impl == "xla"


@pytest.mark.parametrize("impl", ["xla", "gemm", "packed", "packed12"])
def test_explicit_impl_is_untouched(impl):
    cfg = PipelineConfig(method="fcn", conv_impl=impl)
    assert blocks.resolve_conv_impl(cfg).conv_impl == impl
    assert impl in CONV_IMPLS


@pytest.mark.parametrize("impl", ["pallas", "cascade"])
def test_removed_impls_rejected(impl):
    with pytest.raises(ValueError, match="conv_impl"):
        PipelineConfig(conv_impl=impl)
