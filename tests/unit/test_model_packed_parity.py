"""Space-to-depth block-conv ("packed") model stacks vs the XLA-conv
reference applies. The packed form is ONE lax.conv per layer on 4x-channel
activations (ops.patch_conv.conv2d_block_xla), an explicit conv_impl
choice — parity here is its correctness contract."""

import jax
import jax.numpy as jnp
import numpy as np

from low_light_image_enhancement_tpu.models.curve_cnn import (
    apply_curve_cnn,
    apply_curve_cnn_packed,
    init_curve_cnn,
)
from low_light_image_enhancement_tpu.models.decom import (
    apply_decom_net,
    apply_decom_net_packed,
    init_decom_net,
)
from low_light_image_enhancement_tpu.models.fcn import (
    apply_fcn,
    apply_fcn_packed,
    init_fcn,
)
from low_light_image_enhancement_tpu.ops.patch_conv import (
    conv2d_block_xla,
    pack_block_conv_weights,
    space_to_depth,
)


def _img(key, shape):
    return jax.random.uniform(key, shape, jnp.float32)


def test_block_conv_layer_matches_reference_dilations():
    """One packed layer vs lax.conv at every dilation the models use."""
    from low_light_image_enhancement_tpu.models.layers import conv2d

    key = jax.random.PRNGKey(0)
    x = _img(key, (2, 40, 48, 8))
    w = jax.random.normal(jax.random.PRNGKey(1), (3, 3, 8, 8)) * 0.2
    b = jnp.zeros((8,))
    xp = space_to_depth(x)
    for dil in (1, 2, 4, 8, 16, 32):
        want = np.asarray(conv2d(x, w, b, jnp.float32, dilation=dil))
        got = conv2d_block_xla(
            xp, pack_block_conv_weights(w, dilation=dil), b, jnp.float32,
            step=max(1, dil // 2),
        )
        from low_light_image_enhancement_tpu.ops.patch_conv import (
            depth_to_space,
        )

        got = np.asarray(depth_to_space(got))
        np.testing.assert_allclose(got, want, atol=3e-6, err_msg=f"dil={dil}")


def test_block_conv_layer_matches_reference_half_packing():
    """blocks (1, 2) and (2, 1) (per-axis half-packing) vs lax.conv at
    every model dilation."""
    from low_light_image_enhancement_tpu.models.layers import conv2d
    from low_light_image_enhancement_tpu.ops.patch_conv import depth_to_space

    key = jax.random.PRNGKey(10)
    x = _img(key, (2, 40, 48, 8))
    w = jax.random.normal(jax.random.PRNGKey(11), (3, 3, 8, 8)) * 0.2
    b = jnp.zeros((8,))
    for block in ((1, 2), (2, 1)):
        bh, bw = block
        xp = space_to_depth(x, block)
        for dil in (1, 2, 4, 8, 16, 32):
            want = np.asarray(conv2d(x, w, b, jnp.float32, dilation=dil))
            got = conv2d_block_xla(
                xp,
                pack_block_conv_weights(w, dilation=dil, block=block),
                b, jnp.float32,
                step=(max(1, dil // bh), max(1, dil // bw)),
            )
            got = np.asarray(depth_to_space(got, block))
            np.testing.assert_allclose(got, want, atol=3e-6,
                                       err_msg=f"block={block} dil={dil}")


def test_model_packed_half_block_matches_reference():
    """block=(1, 2) end-to-end on all three model stacks."""
    params = init_curve_cnn(jax.random.PRNGKey(20))
    x = _img(jax.random.PRNGKey(21), (2, 3, 24, 32))
    want = np.asarray(apply_curve_cnn(params, x))
    got = np.asarray(apply_curve_cnn_packed(
        params, x, compute_dtype=jnp.float32, block=(1, 2)))
    np.testing.assert_allclose(got, want, atol=3e-5)

    params = init_fcn(jax.random.PRNGKey(22))
    x = _img(jax.random.PRNGKey(23), (1, 3, 80, 96))
    want = np.asarray(apply_fcn(params, x))
    got = np.asarray(apply_fcn_packed(
        params, x, compute_dtype=jnp.float32, block=(1, 2)))
    np.testing.assert_allclose(got, want, atol=3e-5)

    params = init_decom_net(jax.random.PRNGKey(24))
    x = _img(jax.random.PRNGKey(25), (2, 3, 16, 24))
    want_r, want_l = apply_decom_net(params, x)
    got_r, got_l = apply_decom_net_packed(
        params, x, compute_dtype=jnp.float32, block=(1, 2))
    np.testing.assert_allclose(np.asarray(got_r), np.asarray(want_r),
                               atol=3e-5)
    np.testing.assert_allclose(np.asarray(got_l), np.asarray(want_l),
                               atol=3e-5)


def test_block_conv_groups_match_concat():
    """groups=(c, c) routing equals a conv over the channel concat."""
    from low_light_image_enhancement_tpu.models.layers import conv2d
    from low_light_image_enhancement_tpu.ops.patch_conv import depth_to_space

    a = _img(jax.random.PRNGKey(2), (1, 16, 24, 8))
    bt = _img(jax.random.PRNGKey(3), (1, 16, 24, 8))
    w = jax.random.normal(jax.random.PRNGKey(4), (3, 3, 16, 8)) * 0.2
    bias = jnp.zeros((8,))
    want = np.asarray(
        conv2d(jnp.concatenate([a, bt], -1), w, bias, jnp.float32)
    )
    xp = jnp.concatenate([space_to_depth(a), space_to_depth(bt)], -1)
    got = conv2d_block_xla(
        xp, pack_block_conv_weights(w, groups=(8, 8)), bias, jnp.float32
    )
    np.testing.assert_allclose(
        np.asarray(depth_to_space(got)), want, atol=3e-6
    )


def test_curve_cnn_packed_matches_reference():
    params = init_curve_cnn(jax.random.PRNGKey(0))
    x = _img(jax.random.PRNGKey(1), (2, 3, 24, 32))
    want = np.asarray(apply_curve_cnn(params, x))
    got = np.asarray(
        apply_curve_cnn_packed(params, x, compute_dtype=jnp.float32)
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-5)
    got1 = np.asarray(
        apply_curve_cnn_packed(params, x[0], compute_dtype=jnp.float32)
    )
    np.testing.assert_allclose(got1, want[0], atol=3e-5)


def test_fcn_packed_matches_reference():
    params = init_fcn(jax.random.PRNGKey(2))
    # tall enough that the 32-dilation layer has interior pixels
    x = _img(jax.random.PRNGKey(3), (1, 3, 80, 96))
    want = np.asarray(apply_fcn(params, x))
    got = np.asarray(apply_fcn_packed(params, x, compute_dtype=jnp.float32))
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_decom_packed_matches_reference():
    params = init_decom_net(jax.random.PRNGKey(4))
    x = _img(jax.random.PRNGKey(5), (2, 3, 16, 24))
    want_r, want_l = apply_decom_net(params, x)
    got_r, got_l = apply_decom_net_packed(
        params, x, compute_dtype=jnp.float32
    )
    np.testing.assert_allclose(np.asarray(got_r), np.asarray(want_r),
                               atol=3e-5)
    np.testing.assert_allclose(np.asarray(got_l), np.asarray(want_l),
                               atol=3e-5)


def test_packed_grad_flows():
    """The packed path is differentiable (pure slice/concat + lax.conv)."""
    params = init_curve_cnn(jax.random.PRNGKey(6), features=8, n_iter=2)
    x = _img(jax.random.PRNGKey(7), (1, 3, 8, 8))

    def loss(p):
        return jnp.mean(
            apply_curve_cnn_packed(p, x, n_iter=2,
                                   compute_dtype=jnp.float32) ** 2
        )

    g = jax.grad(loss)(params)
    flat = jax.tree_util.tree_leaves(g)
    assert all(np.isfinite(np.asarray(t)).all() for t in flat)
    assert any(float(jnp.abs(t).max()) > 0 for t in flat)


def test_pipeline_conv_impl_packed_routes():
    """conv_impl='packed' validates and produces close output to 'xla'
    through the block graph (CPU, no Pallas tail)."""
    from low_light_image_enhancement_tpu.config import PipelineConfig

    PipelineConfig(method="curve", conv_impl="packed")  # validates
    PipelineConfig(method="fcn", conv_impl="packed12")
    import pytest

    with pytest.raises(ValueError):
        PipelineConfig(method="curve", conv_impl="blocked")


def test_pipeline_packed_impls_match_xla_end_to_end():
    """u8 enhance output through the full block graph is within one u8
    rounding step of the xla route for both packing variants (f32 compute
    pins the only expected divergence to quantize-boundary ties)."""
    from low_light_image_enhancement_tpu.config import PipelineConfig
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    rng = np.random.default_rng(0)
    img = rng.integers(0, 100, (37, 46, 3), np.uint8)  # odd H, even W pad
    outs = {}
    for impl in ("xla", "packed", "packed12"):
        pipe = EnhancePipeline(
            PipelineConfig(method="fcn", conv_impl=impl,
                           compute_dtype="float32"),
            rng_seed=3,
        )
        outs[impl] = pipe.enhance(img).astype(np.int16)
    for impl in ("packed", "packed12"):
        d = np.abs(outs[impl] - outs["xla"])
        assert d.max() <= 1, (impl, d.max())
        assert (d > 0).mean() < 1e-2, (impl, (d > 0).mean())
