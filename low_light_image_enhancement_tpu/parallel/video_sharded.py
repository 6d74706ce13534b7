"""Spatially-sharded temporally-stable video (config 5 × config 4).

A single high-resolution stream (e.g. one 4K feed) whose frames are too
large or too latency-sensitive for one chip: rows shard over the mesh's
``spatial`` axis exactly like ``enhance_spatial_sharded`` (ppermute halo
exchange of u8 rows), while each shard keeps the EMA temporal
carry for its OWN rows — the carry never moves between devices, so the
only per-frame communication is the same halo exchange the stateless
sharded path already pays.

Correctness argument (mirrors the stateless path's): each shard's halo is
the full receptive field (``blocks.learned_halo``), so every carry row the
tail CONSUMES (the ``[halo - MARGIN, halo + rows + MARGIN)`` band) is
computed from exactly the rows the single-device canvas holds — identical
values, hence identical EMA trajectories, hence per-shard outputs
bit-matching a single-device :class:`~..video.VideoEnhancer` up to the
usual cross-jit-context u8 rounding ties (tested at up to 8 shards on
the fake-device CPU
mesh). Carry rows outside the consumed band may drift from their
single-device values; they are never read.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from low_light_image_enhancement_tpu.config import (
    PipelineConfig,
    canvas_margin,
)
from low_light_image_enhancement_tpu.parallel.halo import halo_pad_local
from low_light_image_enhancement_tpu.video import _VideoBase, video_step


class SpatialShardedVideoEnhancer(_VideoBase):
    """One video stream, rows sharded over the mesh's ``spatial`` axis::

        mesh = make_mesh(n_data=1, n_spatial=8)
        sve = SpatialShardedVideoEnhancer(mesh, PipelineConfig(), alpha=0.3)
        for frame in frames_4k:          # (H, W, 3) u8, fixed size
            out = sve.process(frame)
        sve.reset()                       # scene cut

    The ``data`` mesh axis (if any) is unused and replicates. Methods:
    retinex / hybrid / curve, same as :class:`~..video.VideoEnhancer`.
    """

    def __init__(self, mesh: Mesh,
                 config: PipelineConfig = PipelineConfig(),
                 alpha: float = 0.3,
                 model_params: Optional[Dict[str, Any]] = None):
        if "spatial" not in mesh.axis_names:
            raise ValueError(
                f"mesh needs a 'spatial' axis, has {mesh.axis_names}")
        self.mesh = mesh
        self._init_common(config, alpha, model_params)

    # reset() and carry_bytes come from _VideoBase: _carry_shape here is the
    # full (n_shards, ...) stack incl. the per-shard halo overlap rows.

    def _build(self, h: int, w: int) -> None:
        from low_light_image_enhancement_tpu.blocks import (
            block_geometry,
            learned_halo,
            resolve_conv_impl,
        )

        self._shape = (h, w)
        cfg = resolve_conv_impl(self.config)
        self._resolved_cfg = cfg
        alpha, params = self.alpha, self.model_params
        mesh = self.mesh
        n_sp = mesh.shape["spatial"]
        m = canvas_margin(cfg)
        halo = learned_halo(cfg)
        hl, wp = block_geometry(cfg, h, w, n_shards=n_sp)
        h_core = n_sp * hl
        canvas_rows = hl + 2 * halo
        ds = cfg.curve_downsample
        per_shard = (
            (cfg.curve_iters, 3, canvas_rows // ds, wp // ds)
            if cfg.method == "curve"
            else (canvas_rows, wp)
        )
        self._carry_shape = (n_sp,) + per_shard
        carry_spec = P(*(("spatial",) + (None,) * len(per_shard)))

        def local_fn(xl, carry_l, flag):
            # xl: (3, hl, wp) local rows; carry_l: (1,) + per_shard
            xb = halo_pad_local(xl, halo, "spatial")
            row0 = jax.lax.axis_index("spatial") * hl - halo
            (flag2, carry2), y = video_step(
                (flag, carry_l[0]), xb, cfg, alpha, params, h, w, row0=row0,
            )
            return flag2, carry2[None], y

        sharded = shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(None, "spatial", None), carry_spec, P()),
            out_specs=(P(), carry_spec, P(None, "spatial", None)),
            check_vma=False,
        )

        def step(state, u8):
            flag, carry = state
            x = jnp.moveaxis(u8, -1, -3)
            xc = jnp.pad(
                x, ((0, 0), (0, h_core - h), (m, wp - w - m)), mode="edge"
            )
            flag2, carry2, yc = sharded(xc, carry, flag)
            out = yc[..., :h, m : m + w]
            from low_light_image_enhancement_tpu.ops.colorspace import (
                quantize_u8,
            )

            if out.dtype != jnp.uint8:
                out = quantize_u8(out)
            return (flag2, carry2), jnp.moveaxis(out, -3, -1)

        self._step = jax.jit(step)

    def process(self, frame_u8: np.ndarray) -> np.ndarray:
        frame_u8 = np.asarray(frame_u8)
        if frame_u8.ndim != 3 or frame_u8.shape[-1] != 3:
            raise ValueError(
                f"expected an (H, W, 3) u8 frame, got {frame_u8.shape}")
        h, w, _ = frame_u8.shape
        if self._shape is None:
            self._build(h, w)
        elif (h, w) != self._shape:
            raise ValueError(
                f"frame size changed {self._shape} -> {(h, w)}; "
                "create a new SpatialShardedVideoEnhancer"
            )
        if self._state is None:
            self._state = (jnp.zeros((), bool),
                           jnp.zeros(self._carry_shape))
        self._state, out = self._step(self._state, jnp.asarray(frame_u8))
        return np.asarray(out)
