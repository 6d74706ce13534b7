"""Mesh construction and sharded execution wrappers.

A flat 2-D ``Mesh`` with a ``data`` axis (batch parallelism) and a
``spatial`` axis (image rows, for frames too large or too latency-sensitive
for one device — BASELINE.json config 5). The devices of one host are
joined all to all, so the mesh follows the algorithm alone. XLA collectives
do all communication: ``ppermute`` halo exchange for windowed filters,
automatic gradient ``psum`` for sharded training.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from low_light_image_enhancement_tpu.config import PipelineConfig
from low_light_image_enhancement_tpu.config import canvas_margin
from low_light_image_enhancement_tpu.core import enhance_core_padded
from low_light_image_enhancement_tpu.kernels.fused_enhance import fused_retinex
from low_light_image_enhancement_tpu.ops.colorspace import (
    normalize_u8,
    quantize_u8,
)
from low_light_image_enhancement_tpu.parallel.halo import halo_pad_local


def make_mesh(
    n_data: Optional[int] = None,
    n_spatial: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ("data", "spatial") mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        if len(devices) % n_spatial:
            raise ValueError(
                f"{len(devices)} devices not divisible by n_spatial={n_spatial}"
            )
        n_data = len(devices) // n_spatial
    need = n_data * n_spatial
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.asarray(devices[:need]).reshape(n_data, n_spatial)
    return Mesh(grid, ("data", "spatial"))


def shard_batch_fn(fn: Callable, mesh: Mesh) -> Callable:
    """Data-parallel wrapper: shards arg 0's leading (batch) dim over every
    mesh device and lets XLA propagate shardings through the jitted fn."""
    jitted = jax.jit(fn)
    spec = NamedSharding(mesh, P(("data", "spatial")))

    @functools.wraps(fn)
    def wrapped(batch, *rest):
        batch = jax.device_put(batch, spec)
        return jitted(batch, *rest)

    return wrapped


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def enhance_spatial_sharded(
    x: jnp.ndarray,
    cfg: PipelineConfig,
    mesh: Mesh,
    model_params=None,
    use_kernel: bool = False,
    interpret: bool = False,
) -> jnp.ndarray:
    """Spatially-sharded enhance (config 5: per-shard denoise), any method.

    Args:
      x: (B, 3, H, W) planar batch — float32 in [0, 1], or uint8 (halos
        then exchange u8 rows at 1/4 the bytes; each shard converts at its
        own boundary, or runs the fused u8 kernel when ``use_kernel``).
      mesh: mesh with a "spatial" axis; rows shard across it, batch across
        "data". Output is bit-identical to the single-device path: for
        retinex the halo exchange reproduces the padded-canvas rows, for
        learned methods each shard runs the same ``enhance_learned_block``
        the pipeline runs, with halo = the net's receptive field
        (``blocks.learned_halo``).
      model_params: weights for the learned methods (ignored for retinex).

    Returns (B, 3, H, W) enhanced, same dtype as the input.
    """
    if cfg.method != "retinex":
        if model_params is None:
            raise ValueError(
                f"method={cfg.method!r} needs model_params (e.g. "
                "EnhancePipeline._default_params(cfg, seed) or trained "
                "weights); only 'retinex' runs weight-free"
            )
        return _enhance_learned_sharded(x, cfg, mesh, model_params)
    u8_io = x.dtype == jnp.uint8
    if use_kernel and not u8_io:
        raise ValueError("the fused kernel takes uint8 input")
    n_sp = mesh.shape["spatial"]
    b, c, h, w = x.shape
    m = canvas_margin(cfg)
    hl = _round_up(-(-h // n_sp), 8)  # rows per shard
    h_core = n_sp * hl
    xc = jnp.pad(x, ((0, 0), (0, 0), (0, h_core - h), (m, m)), mode="edge")

    def local_fn(xl):  # (B/nd, 3, hl, w + 2m) per device
        canvas = halo_pad_local(xl, m, "spatial")  # (.., hl + 2m, w + 2m)
        if use_kernel:
            # the kernel clamps at the canvas edge; the m-px margin keeps
            # every output row it returns clear of that edge
            out = fused_retinex(canvas, cfg, interpret=interpret)
        else:
            yp = enhance_core_padded(normalize_u8(canvas) if u8_io
                                     else canvas, cfg)
            out = quantize_u8(yp) if u8_io else yp
        return out[..., m : m + hl, :]

    sharded = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=P("data", None, "spatial", None),
        out_specs=P("data", None, "spatial", None),
        # pallas_call's out_shape carries no varying-mesh-axes annotation;
        # skip the vma check for the fused kernel (the specs above fully
        # describe the layout).
        check_vma=not use_kernel,
    )
    out_core = sharded(xc)
    return out_core[..., :h, m : m + w]


def _enhance_learned_sharded(
    x: jnp.ndarray,
    cfg: PipelineConfig,
    mesh: Mesh,
    model_params,
) -> jnp.ndarray:
    """Spatial sharding of the learned methods: per-shard
    ``blocks.enhance_learned_block`` with ppermute halos sized to the net's
    receptive field (curve CNN radius 7; fcn dilation stack radius 64 —
    VERDICT r1 item 2). Bit-parity with the single-device pipeline holds by
    construction: both run the identical block function, and
    ``halo_pad_local`` reproduces exactly the rows the pipeline's edge
    padding produces."""
    from low_light_image_enhancement_tpu.blocks import (
        block_geometry,
        enhance_learned_block,
        learned_halo,
    )

    # u8 input flows through as u8: halos exchange u8 rows (1/4 the bytes)
    # and the block converts at its own boundary.
    n_sp = mesh.shape["spatial"]
    b, c, h, w = x.shape
    m = canvas_margin(cfg)
    halo = learned_halo(cfg)
    hl, wp = block_geometry(cfg, h, w, n_shards=n_sp)
    h_core = n_sp * hl
    xc = jnp.pad(
        x, ((0, 0), (0, 0), (0, h_core - h), (m, wp - w - m)), mode="edge"
    )

    def local_fn(xl, params):  # (B/nd, 3, hl, wp) per device
        xb = halo_pad_local(xl, halo, "spatial")
        row0 = jax.lax.axis_index("spatial") * hl - halo
        return enhance_learned_block(xb, cfg, params, row0, h, w)

    sharded = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P("data", None, "spatial", None), P()),
        out_specs=P("data", None, "spatial", None),
    )
    return sharded(xc, model_params)[..., :h, m : m + w]
