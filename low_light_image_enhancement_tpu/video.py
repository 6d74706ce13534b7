"""Temporally-stable video enhancement (config 4's video-frame use case).

Per-frame enhancement flickers when the per-frame estimates jitter. For each
method the natural temporal carry is smoothed with an exponential moving
average across frames:

  * retinex / hybrid — the *illumination map*: structure (reflectance) stays
    per-frame sharp while the gain field evolves smoothly, the standard
    temporal-consistency trick for Retinex pipelines.
  * curve — the *LE-curve parameter maps* from the Zero-DCE estimator: the
    per-pixel adjustment curves evolve smoothly while each frame is curved
    individually.
  * fcn / decom — no low-dimensional carry exists (the net's output IS the
    frame); use ``EnhancePipeline.enhance_stream`` for those.

Functional core (``video_step``) is jit-compatible with explicit carry state
and runs on the same halo'd row block as ``blocks.enhance_learned_block``;
``VideoEnhancer`` wraps it with a Python-side state holder and the u8 HWC
API.

The EMA state is the *compact* temporal quantity — the illumination plane
for retinex/hybrid, the 1/ds low-res curve maps for curve (ds^2 x smaller
than a full-res map carry). The step is plain ``jax.numpy``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from low_light_image_enhancement_tpu.blocks import (
    _curve_maps_lowres,
    _mask_extent,
    block_geometry,
    enhance_learned_block,
    learned_halo,
    replicate_margin_cols,
)
from low_light_image_enhancement_tpu.config import (
    PipelineConfig,
    canvas_margin,
)
from low_light_image_enhancement_tpu.ops.colorspace import (
    normalize_u8,
    quantize_u8,
)
from low_light_image_enhancement_tpu.ops.curves import apply_curves
from low_light_image_enhancement_tpu.ops.denoise import denoise_planar
from low_light_image_enhancement_tpu.ops.filters import roll2d, separable_blur

State = Tuple[jnp.ndarray, jnp.ndarray]  # (initialized flag, EMA carry)

_VIDEO_METHODS = ("retinex", "hybrid", "curve")

def _bcast_flag(flag: jnp.ndarray, like: jnp.ndarray) -> jnp.ndarray:
    """Right-pad the initialized flag with singleton axes so it broadcasts
    against the carry: scalar () for a single stream, (S,) -> (S, 1, ...)
    for the multi-stream batch (one flag per stream, so per-stream resets
    re-seed only that stream's EMA)."""
    return flag.reshape(flag.shape + (1,) * (like.ndim - flag.ndim))


def _illum(xb: jnp.ndarray, cfg: PipelineConfig) -> jnp.ndarray:
    return separable_blur(jnp.max(xb, axis=-3), cfg.blur_radius,
                          cfg.blur_sigma, roll2d)


def _denoise_tail(y: jnp.ndarray, cfg: PipelineConfig) -> jnp.ndarray:
    if cfg.denoise_strength > 0.0:
        inv2s2 = 1.0 / (2.0 * cfg.denoise_sigma * cfg.denoise_sigma)
        y = denoise_planar(y, inv2s2, cfg.denoise_strength, roll2d,
                           cfg.denoise_kernel, cfg.denoise_guide,
                           cfg.denoise_taps, cfg.guided_radius,
                           cfg.guided_eps)
    return jnp.clip(y, 0.0, 1.0)


def video_step(
    state: State,
    xb: jnp.ndarray,
    cfg: PipelineConfig,
    alpha: float,
    model_params: Optional[Dict[str, Any]] = None,
    h: Optional[int] = None,
    w: Optional[int] = None,
    row0=None,
) -> Tuple[State, jnp.ndarray]:
    """One frame on a halo'd block (3, HB, WB) — or one frame PER STREAM on
    a batched block (S, 3, HB, WB) with a per-stream flag of shape (S,) and
    a carry with leading stream axis — f32 in [0, 1], or uint8 (output
    dtype matches the input).

    ``alpha`` is the new-frame weight of the EMA (1.0 = no smoothing = the
    stateless pipeline); it may be traced. The carry is the compact
    temporal quantity: the (HB, WB) illumination plane for retinex/hybrid,
    the (n_iter, 3, HB/ds, WB/ds) LOW-RES curve maps for curve —
    EMA-then-upsample equals upsample-then-EMA (both linear), so
    downsampled smoothing loses nothing while cutting the carry by ds^2.
    Returns (new_state, enhanced interior rows (3, HB - 2*halo, WB));
    columns are cropped by the caller.
    """
    initialized, carry = state
    from low_light_image_enhancement_tpu.blocks import resolve_conv_impl

    cfg = resolve_conv_impl(cfg)
    halo = learned_halo(cfg)
    rows = xb.shape[-2] - 2 * halo
    if h is None:
        h = rows
    if w is None:
        w = xb.shape[-1] - 2 * canvas_margin(cfg)
    if row0 is None:
        # single-block case: the block's first row is image row -halo. A
        # spatially-sharded caller passes its own (possibly traced) offset,
        # e.g. axis_index("spatial") * rows_per_shard - halo.
        row0 = -halo
    u8_io = xb.dtype == jnp.uint8
    xf = normalize_u8(xb) if u8_io else xb

    def _finish(y):
        y = y[..., halo : halo + rows, :]
        return quantize_u8(y) if u8_io else y

    if cfg.method in ("retinex", "hybrid"):
        l_now = _illum(xf, cfg)
        l_mix = jnp.where(_bcast_flag(initialized, l_now),
                          alpha * l_now + (1.0 - alpha) * carry, l_now)
        # Reflectance from the PER-FRAME illumination (cancels frame-to-frame
        # flicker in the input), re-lit with the temporally-smoothed EMA
        # illumination: out = (x / L_now) * L_ema**gamma. At alpha=1 this is
        # the stateless x * L**(gamma-1) path (same value, one extra log).
        l_now_safe = jnp.clip(l_now, cfg.illum_eps, 1.0)
        l_mix_safe = jnp.clip(l_mix, cfg.illum_eps, 1.0)
        gain = jnp.exp(cfg.gamma * jnp.log(l_mix_safe) - jnp.log(l_now_safe))
        # the blur wraps MARGIN cols at the canvas edge; restore the
        # column-replica invariant before anything consumes the gain
        gain = replicate_margin_cols(gain, w, canvas_margin(cfg))
        new_state = (jnp.ones_like(initialized), l_mix)

        if cfg.method == "hybrid":
            boosted = jnp.clip(xf * gain[..., None, :, :], 0.0, 1.0)
            out = enhance_learned_block(
                xb, cfg, model_params, row0=row0, h=h, w=w,
                pre_boosted=boosted,
            )
            return new_state, out
        y = _denoise_tail(jnp.clip(xf * gain[..., None, :, :], 0.0, 1.0), cfg)
        return new_state, _finish(y)

    if cfg.method == "curve":
        cnn_in = _mask_extent(xf, row0, h, w, canvas_margin(cfg))
        ds = cfg.curve_downsample
        maps_now = _curve_maps_lowres(cnn_in, cfg, model_params)
        maps = jnp.where(_bcast_flag(initialized, maps_now),
                         alpha * maps_now + (1.0 - alpha) * carry, maps_now)
        new_state = (jnp.ones_like(initialized), maps)
        if ds > 1:
            from low_light_image_enhancement_tpu.ops.filters import (
                shift2d,
                upsample_int,
            )

            maps_full = upsample_int(maps, ds, axis=-1, shift_fn=shift2d)
            maps_full = upsample_int(maps_full, ds, axis=-2, shift_fn=shift2d)
        else:
            maps_full = maps
        y = _denoise_tail(jnp.clip(apply_curves(xf, maps_full), 0.0, 1.0),
                          cfg)
        return new_state, _finish(y)

    raise ValueError(
        f"video path supports methods {_VIDEO_METHODS} (no temporal carry "
        f"exists for {cfg.method!r}; use EnhancePipeline.enhance_stream)"
    )


def _make_step(cfg: PipelineConfig, alpha: float, params, h: int, w: int):
    """Build the rank-agnostic jittable frame step and the per-stream carry
    shape for an (h, w) frame size: the same function serves a single
    (H, W, 3) frame and an (S, H, W, 3) multi-stream batch (channel axis is
    moved to -3 either way, and the flag/carry lead with the stream axis)."""
    m = canvas_margin(cfg)
    halo = learned_halo(cfg)
    h_core, wp = block_geometry(cfg, h, w)

    def step(state, u8):
        x = jnp.moveaxis(u8, -1, -3)
        lead = ((0, 0),) * (x.ndim - 2)
        xb = jnp.pad(
            x, lead + ((halo, halo + h_core - h), (m, wp - w - m)),
            mode="edge",
        )
        state, yb = video_step(state, normalize_u8(xb), cfg, alpha, params,
                               h, w)
        out = yb[..., :h, m : m + w]
        if out.dtype != jnp.uint8:
            out = quantize_u8(out)
        return state, jnp.moveaxis(out, -3, -1)

    ds = cfg.curve_downsample
    carry_shape = (
        (cfg.curve_iters, 3, (h_core + 2 * halo) // ds, wp // ds)
        if cfg.method == "curve"
        else (h_core + 2 * halo, wp)
    )
    return step, carry_shape


class _VideoBase:
    """Shared state/compile plumbing for the single- and multi-stream
    enhancers: method validation, default-weight loading, and the
    compile-on-first-frame step builder."""

    def _init_common(self, config: PipelineConfig, alpha: float,
                     model_params: Optional[Dict[str, Any]]) -> None:
        if config.method not in _VIDEO_METHODS:
            raise ValueError(
                f"video path supports methods {_VIDEO_METHODS}, got "
                f"{config.method!r}; use EnhancePipeline.enhance_stream for "
                "per-frame fcn/decom"
            )
        self.config = config
        self.alpha = float(alpha)
        if model_params is None and config.method != "retinex":
            from low_light_image_enhancement_tpu.pipeline import (
                EnhancePipeline,
            )

            model_params = EnhancePipeline._default_params(config, 0)
        self.model_params = model_params
        self._state: Optional[State] = None
        self._step = None
        self._shape: Optional[Tuple[int, int]] = None

    def _build(self, h: int, w: int) -> None:
        """Build + jit the frame step for an (h, w) frame size."""
        from low_light_image_enhancement_tpu.blocks import resolve_conv_impl

        self._shape = (h, w)
        self._resolved_cfg = resolve_conv_impl(self.config)
        step, self._carry_shape = _make_step(
            self._resolved_cfg, self.alpha, self.model_params, h, w)
        self._step = jax.jit(step)

    def reset(self) -> None:
        self._state = None

    @property
    def carry_bytes(self) -> int:
        """EMA carry size in bytes (after the first `process` call) — the
        compact temporal state: illumination plane (retinex/hybrid) or 1/ds
        low-res curve maps (curve). Covers all shards/streams where the
        subclass carries more than one."""
        if self._shape is None:
            raise RuntimeError("carry_bytes is defined after a first frame")
        return int(np.prod(self._carry_shape)) * 4


class VideoEnhancer(_VideoBase):
    """Stateful u8 HWC video interface::

        ve = VideoEnhancer(PipelineConfig(), alpha=0.3)
        for frame in frames:            # (H, W, 3) u8, fixed size
            out = ve.process(frame)
        ve.reset()                       # scene cut
    """

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 alpha: float = 0.3,
                 model_params: Optional[Dict[str, Any]] = None):
        self._init_common(config, alpha, model_params)

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
                "create a new VideoEnhancer (or call one per stream)"
            )
        if self._state is None:
            self._state = (jnp.zeros((), bool),
                           jnp.zeros(self._carry_shape))
        self._state, out = self._step(self._state, jnp.asarray(frame_u8))
        return np.asarray(out)


class MultiStreamVideoEnhancer(_VideoBase):
    """S independent video streams enhanced in ONE batched device step.

    The stateful curve/hybrid video step runs the CNN at batch 1 per frame;
    batching one frame from each of S streams gives the device a batched
    step while the EMA carry stays strictly per-stream — stream i's output
    matches running it alone through :class:`VideoEnhancer`
    (``tests/integration/test_video.py``).

    ::

        mv = MultiStreamVideoEnhancer(8, PipelineConfig(method="curve"))
        for frames in batches:          # (8, H, W, 3) u8, one frame/stream
            outs = mv.process(frames)   # (8, H, W, 3)
        mv.reset(3)                      # scene cut in stream 3 only
    """

    def __init__(self, n_streams: int,
                 config: PipelineConfig = PipelineConfig(),
                 alpha: float = 0.3,
                 model_params: Optional[Dict[str, Any]] = None):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.n_streams = int(n_streams)
        self._init_common(config, alpha, model_params)

    def reset(self, stream: Optional[int] = None) -> None:
        """Re-seed the EMA — all streams, or just ``stream`` (scene cut in
        one stream leaves the others' temporal state untouched)."""
        if stream is None:
            self._state = None
            return
        if not 0 <= stream < self.n_streams:
            raise ValueError(
                f"stream {stream} out of range [0, {self.n_streams})")
        if self._state is not None:
            flag, carry = self._state
            self._state = (flag.at[stream].set(False), carry)

    @property
    def carry_bytes(self) -> int:
        """Total EMA carry across streams (after the first `process`)."""
        if self._shape is None:
            raise RuntimeError("carry_bytes is defined after a first frame")
        return self.n_streams * int(np.prod(self._carry_shape)) * 4

    def process(self, frames_u8: np.ndarray) -> np.ndarray:
        frames_u8 = np.asarray(frames_u8)
        if (frames_u8.ndim != 4 or frames_u8.shape[0] != self.n_streams
                or frames_u8.shape[-1] != 3):
            raise ValueError(
                f"expected (n_streams={self.n_streams}, H, W, 3) u8 frames, "
                f"got {frames_u8.shape}"
            )
        _, h, w, _ = frames_u8.shape
        if self._shape is None:
            self._build(h, w)
        elif (h, w) != self._shape:
            raise ValueError(
                f"frame size changed {self._shape} -> {(h, w)}; "
                "create a new MultiStreamVideoEnhancer"
            )
        if self._state is None:
            self._state = (
                jnp.zeros((self.n_streams,), bool),
                jnp.zeros((self.n_streams,) + self._carry_shape),
            )
        self._state, out = self._step(self._state, jnp.asarray(frames_u8))
        return np.asarray(out)
