"""Pipeline assembly: the public ``enhance`` API over the compiled graph.

Responsibilities (SURVEY.md L3): layout conversion at the API boundary
(u8 HWC <-> planar f32), edge padding, jit-cache discipline (one compile
per (batch, H, W, config) bucket), and dispatch between the fused retinex
kernel and the plain ``jax.numpy`` graph (``backend.use_kernel``).
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from low_light_image_enhancement_tpu import backend
from low_light_image_enhancement_tpu.config import (
    PipelineConfig,
    canvas_margin,
)
from low_light_image_enhancement_tpu.core import enhance_core_padded
from low_light_image_enhancement_tpu.kernels.fused_enhance import fused_retinex
from low_light_image_enhancement_tpu.models.curve_cnn import init_curve_cnn
from low_light_image_enhancement_tpu.ops.colorspace import (
    normalize_u8,
    quantize_u8,
)


def pad_planar(x: jnp.ndarray, margin: int) -> jnp.ndarray:
    """Edge-replicate pad (..., C, H, W) by ``margin`` rows/cols per side:
    the canvas the plain graph filters with wrap-around shifts."""
    pad = [(0, 0)] * (x.ndim - 2) + [(margin, margin), (margin, margin)]
    return jnp.pad(x, pad, mode="edge")


def _isp_u8_hwc(raws: jnp.ndarray, wb_gains, ccm, raw_gamma: float,
                valid_hw=None) -> jnp.ndarray:
    """Traced ISP front-end: (B, H, W) f32 RGGB mosaic -> (B, H, W, 3) u8
    sRGB (ops.isp stages, RAW->sRGB per PAPERS.md:5,7).

    Reflect-pads 2 px per side before the demosaic: the roll-based
    interpolation wraps at edges, and reflection preserves Bayer phase
    (position -k mirrors +k, same parity), so the crop afterwards gives
    exact borders. Gray-world WB gains (``wb_gains=None``) are computed on
    the CROPPED demosaic — not the padded canvas — so auto-WB matches
    composing ``ops.isp`` stages on the unpadded mosaic exactly (ADVICE r4:
    padded-canvas statistics double-weighted the 2 px borders). With
    ``valid_hw=(h, w)`` the statistics restrict further to the real image
    region of a bucket-padded mosaic."""
    from low_light_image_enhancement_tpu.ops.isp import (
        color_correction,
        demosaic_bilinear_rggb,
        gray_world_gains,
        white_balance,
    )

    rp = jnp.pad(raws, ((0, 0), (2, 2), (2, 2)), mode="reflect")
    rgb = demosaic_bilinear_rggb(rp)[..., 2:-2, 2:-2]
    if wb_gains is None:
        if valid_hw is None:
            gains = gray_world_gains(rgb)  # (B, 3): per-image auto-WB
        else:
            # bucket-padded mosaic: valid_hw is a TRACED (2,) extent, so
            # one compiled program serves every size in the bucket while
            # the statistics restrict to the real image region via a mask
            hgt, wdt = rgb.shape[-2:]
            mask = (
                (jnp.arange(hgt)[:, None] < valid_hw[0])
                & (jnp.arange(wdt)[None, :] < valid_hw[1])
            ).astype(rgb.dtype)
            cnt = jnp.maximum(valid_hw[0] * valid_hw[1], 1).astype(rgb.dtype)
            means = jnp.sum(rgb * mask, axis=(-2, -1)) / cnt
            gains = means[..., 1:2] / jnp.maximum(means, 1e-6)
        gains = gains.reshape(gains.shape[:-1] + (3, 1, 1))
        rgb = jnp.clip(rgb * gains, 0.0, 1.0)
    else:
        rgb = white_balance(rgb, jnp.asarray(wb_gains))
    rgb = color_correction(rgb, ccm)
    rgb = jnp.clip(rgb, 0.0, 1.0) ** raw_gamma
    return jnp.transpose(quantize_u8(rgb), (0, 2, 3, 1))


def _enhance_u8_batch(
    imgs_u8: jnp.ndarray,
    model_params: Optional[Dict[str, Any]],
    *,
    cfg: PipelineConfig,
    use_kernel: bool,
    interpret: bool,
    planar_io: bool = False,
) -> jnp.ndarray:
    """Traced body: (B, H, W, 3) u8 -> (B, H, W, 3) u8 enhanced.

    ``planar_io=True`` takes and returns (B, 3, H, W) u8 instead, so the
    HWC<->planar transposes leave the device program (streaming workloads
    stage planar on the host)."""
    if planar_io:
        _, _, h, w = imgs_u8.shape
    else:
        _, h, w, _ = imgs_u8.shape

    def to_planar(x):
        return x if planar_io else jnp.transpose(x, (0, 3, 1, 2))

    def from_planar(y):
        return y if planar_io else jnp.transpose(y, (0, 2, 3, 1))

    if cfg.method == "retinex":
        if use_kernel:
            return from_planar(fused_retinex(to_planar(imgs_u8), cfg,
                                             interpret=interpret))
        m = canvas_margin(cfg)
        xp = pad_planar(normalize_u8(to_planar(imgs_u8)), m)
        y = enhance_core_padded(xp, cfg)[:, :, m : m + h, m : m + w]
        return from_planar(quantize_u8(y))

    # Learned methods (curve / hybrid / fcn / decom): the block graph of
    # blocks.enhance_learned_block — the same function the spatially-sharded
    # path runs per shard, so config-5 output matches this bit-for-bit.
    from low_light_image_enhancement_tpu.blocks import (
        block_geometry,
        enhance_learned_block,
        single_block_halo,
    )

    # Minimal single-block canvas: bit-identical to the full receptive-field
    # halo (blocks.single_block_halo derivation) on a smaller canvas — for
    # curve ds=4 at 600x400 this cuts CNN+tail rows 528->464.
    halo = single_block_halo(cfg)
    h_core, wp = block_geometry(cfg, h, w)
    m = canvas_margin(cfg)
    # u8 block end-to-end: normalization happens inside the block,
    # quantization on the way out.
    xb = jnp.pad(
        to_planar(imgs_u8),
        ((0, 0), (0, 0), (halo, halo + h_core - h), (m, wp - w - m)),
        mode="edge",
    )
    yb = enhance_learned_block(
        xb, cfg, model_params, row0=-halo, h=h, w=w, halo=halo,
    )
    return from_planar(yb[..., :h, m : m + w])


class EnhancePipeline:
    """Compiled low-light enhancement pipeline.

    Example::

        pipe = EnhancePipeline(PipelineConfig(gamma=0.5))
        out = pipe.enhance(img_u8_hwc)
    """

    def __init__(
        self,
        config: PipelineConfig = PipelineConfig(),
        model_params: Optional[Dict[str, Any]] = None,
        rng_seed: int = 0,
        force_jnp: bool = False,
        pallas_interpret: bool = False,
        bucket: Optional[int] = None,
        curve_params: Optional[Dict[str, Any]] = None,  # legacy alias
    ):
        """``model_params``: weights for the learned methods — the curve CNN
        for "curve"/"hybrid", the FCN enhancer for "fcn"; freshly initialized
        from ``rng_seed`` when omitted.

        ``force_jnp`` pins the plain graph; ``pallas_interpret`` runs the
        fused kernel under the Pallas interpreter (``backend.use_kernel``).

        ``bucket``: optional size granularity. When set, inputs are
        edge-padded up to multiples of ``bucket`` before compilation and the
        output is cropped back — so a stream of varying image sizes hits a
        bounded number of compiled programs instead of one per exact shape
        (SURVEY.md §7 hard part (e))."""
        self.config = config
        self.bucket = bucket
        if model_params is None:
            model_params = curve_params
        if model_params is None:
            model_params = self._default_params(config, rng_seed)
        self.model_params = model_params
        self._use_kernel = backend.use_kernel(config, force_jnp=force_jnp,
                                              interpret=pallas_interpret)
        self._interpret = pallas_interpret
        if config.data_shards > 1:
            backend.require_devices(config.data_shards, "data_shards")
        if config.spatial_shards > 1:
            backend.require_devices(config.spatial_shards, "spatial_shards")
        self._cache: Dict[Tuple[int, int, int], Any] = {}
        # Guards cache fills under concurrent callers (e.g. HTTP worker
        # threads sharing one pipeline): without it, two first-call threads
        # build DISTINCT jit wrappers for the same shape and XLA compiles
        # the program twice (jax caches per function object). Execution
        # itself is thread-safe; this only dedups compiles.
        self._cache_lock = threading.Lock()

    # ------------------------------------------------------------------ #

    @staticmethod
    def _default_params(config: PipelineConfig, rng_seed: int):
        """Repo-shipped pretrained weights when present and shape-compatible
        with the config; fresh random init otherwise. A config carrying
        ``weights_name`` resolves that shipped name instead (presets whose
        quality numbers were measured with specific weights)."""
        from low_light_image_enhancement_tpu.models.weights import (
            load_pretrained,
        )

        if config.weights_name is not None:
            from low_light_image_enhancement_tpu.models.weights import (
                resolve_weights,
            )

            return resolve_weights(config.weights_name)

        if config.method in ("curve", "hybrid"):
            pre = load_pretrained(config.method)
            if (
                pre is not None
                and pre["c1"]["w"].shape[-1] == config.curve_features
                and pre["c7"]["w"].shape[-1] == 3 * config.curve_iters
            ):
                return pre
            return init_curve_cnn(
                jax.random.PRNGKey(rng_seed),
                features=config.curve_features,
                n_iter=config.curve_iters,
            )
        if config.method == "fcn":
            from low_light_image_enhancement_tpu.models.fcn import init_fcn

            pre = load_pretrained("fcn")
            if pre is not None:
                return pre
            return init_fcn(jax.random.PRNGKey(rng_seed))
        if config.method == "decom":
            from low_light_image_enhancement_tpu.models.decom import (
                init_decom_net,
            )

            pre = load_pretrained("decom")
            if pre is not None:
                return pre
            return init_decom_net(jax.random.PRNGKey(rng_seed))
        return None

    def _compiled(self, b: int, h: int, w: int, planar_io: bool = False):
        key = (b, h, w, planar_io)
        fn = self._cache.get(key)
        if fn is None:
            with self._cache_lock:
                fn = self._cache.get(key)
                if fn is not None:
                    return fn
                fn = jax.jit(
                    functools.partial(
                        _enhance_u8_batch,
                        cfg=self.config,
                        use_kernel=self._use_kernel,
                        interpret=self._interpret,
                        planar_io=planar_io,
                    )
                )
                self._cache[key] = fn
        return fn

    def warmup(self, shapes) -> None:
        """Pre-compile for a list of (batch, height, width) shapes so the
        first real request doesn't pay XLA compile latency (serving cold-
        start). Respects ``bucket`` by rounding shapes the same way."""
        for b, h, w in shapes:
            if self.bucket:
                g = self.bucket
                h, w = -(-h // g) * g, -(-w // g) * g
            dummy = jnp.zeros((b, h, w, 3), jnp.uint8)
            # Route through the real dispatch so the sharded jit (config 5)
            # is the one pre-compiled when spatial_shards > 1.
            self.enhance_batch_device(dummy)

    def enhance_batch_device(self, imgs_u8) -> jnp.ndarray:
        """(B, H, W, 3) u8 -> enhanced u8, left on device (no host sync)."""
        b, h, w, c = imgs_u8.shape
        if c != 3:
            raise ValueError(f"expected RGB (B,H,W,3), got {imgs_u8.shape}")
        if imgs_u8.dtype != jnp.uint8:
            raise TypeError(
                f"expected uint8 input, got {imgs_u8.dtype}; for float "
                "planar data use core.enhance_core_padded / "
                "parallel.enhance_spatial_sharded"
            )
        if self.config.spatial_shards > 1:
            return self._sharded(b, h, w)(imgs_u8)
        if self.config.data_shards > 1:
            n = self.config.data_shards
            if b % n:
                raise ValueError(
                    f"batch {b} not divisible by data_shards={n}; "
                    "enhance_batch pads the batch for you"
                )
            imgs_u8 = jax.device_put(imgs_u8, self._data_sharding(n))
        return self._compiled(b, h, w)(imgs_u8, self.model_params)

    def enhance_batch_device_planar(self, imgs_pu8) -> jnp.ndarray:
        """(B, 3, H, W) PLANAR u8 -> enhanced planar u8, left on device.

        The layout-persistent entry point: no HWC<->planar transpose runs
        on device. Use when frames stay on device between steps or when the
        host stages planar in the prefetch workers
        (``io.prefetch.to_planar``)."""
        b, c, h, w = imgs_pu8.shape
        if c != 3:
            raise ValueError(
                f"expected planar RGB (B,3,H,W), got {imgs_pu8.shape}")
        if imgs_pu8.dtype != jnp.uint8:
            raise TypeError(f"expected uint8 input, got {imgs_pu8.dtype}")
        if self.config.spatial_shards > 1:
            raise NotImplementedError(
                "planar I/O is a single-device/DP fast path; the spatially-"
                "sharded route is already planar internally — use "
                "parallel.enhance_spatial_sharded directly"
            )
        if self.config.data_shards > 1:
            n = self.config.data_shards
            if b % n:
                raise ValueError(
                    f"batch {b} not divisible by data_shards={n}")
            imgs_pu8 = jax.device_put(imgs_pu8, self._data_sharding(n))
        return self._compiled(b, h, w, planar_io=True)(
            imgs_pu8, self.model_params)

    def _data_sharding(self, n: int):
        """NamedSharding splitting the batch dim over an n-device 'data'
        mesh. The batch-sharded program is collective-free (structurally
        asserted in tests/parallel/test_dp_scaling.py), so n devices run the
        identical per-device program concurrently — DP serving is input
        placement, not a new graph."""
        key = ("data_sharding", n)
        sh = self._cache.get(key)
        if sh is None:
            from jax.sharding import NamedSharding, PartitionSpec
            from low_light_image_enhancement_tpu.parallel.sharding import (
                make_mesh,
            )

            with self._cache_lock:
                sh = self._cache.get(key)
                if sh is None:
                    mesh = make_mesh(n_data=n, n_spatial=1)
                    sh = NamedSharding(mesh, PartitionSpec("data"))
                    self._cache[key] = sh
        return sh

    def _sharded(self, b: int, h: int, w: int):
        """Spatially-sharded execution (config 5): rows split over a
        'spatial' mesh axis with halo exchange, u8 in and out."""
        key = ("sharded", b, h, w)
        fn = self._cache.get(key)
        if fn is not None:
            return fn
        with self._cache_lock:
            fn = self._cache.get(key)
            if fn is not None:
                return fn
            from low_light_image_enhancement_tpu.parallel.sharding import (
                enhance_spatial_sharded,
                make_mesh,
            )

            mesh = make_mesh(n_data=1, n_spatial=self.config.spatial_shards)
            cfg = self.config
            use_kernel = self._use_kernel
            interp = self._interpret
            params = self.model_params

            def run(imgs_u8):
                x = jnp.transpose(imgs_u8, (0, 3, 1, 2))
                y = enhance_spatial_sharded(
                    x, cfg, mesh, model_params=params,
                    use_kernel=use_kernel, interpret=interp,
                )
                return jnp.transpose(y, (0, 2, 3, 1))

            fn = jax.jit(run)
            self._cache[key] = fn
        return fn

    def enhance_batch(self, imgs_u8) -> np.ndarray:
        """(B, H, W, 3) u8 -> (B, H, W, 3) u8 enhanced (host numpy)."""
        imgs_u8 = np.asarray(imgs_u8)
        n = self.config.data_shards
        if n > 1:
            b = imgs_u8.shape[0]
            if b % n:
                pad = n - b % n  # replicate the last image up to a multiple
                padded = np.concatenate(
                    [imgs_u8, np.repeat(imgs_u8[-1:], pad, axis=0)]
                )
                return self.enhance_batch(padded)[:b]  # now divisible
        if self.bucket:
            g = self.bucket
            _, h, w, _ = imgs_u8.shape
            hb, wb = -(-h // g) * g, -(-w // g) * g
            if (hb, wb) != (h, w):
                padded = np.pad(
                    imgs_u8, ((0, 0), (0, hb - h), (0, wb - w), (0, 0)),
                    mode="edge",
                )
                out = np.asarray(
                    self.enhance_batch_device(jnp.asarray(padded))
                )
                return out[:, :h, :w]
        return np.asarray(self.enhance_batch_device(jnp.asarray(imgs_u8)))

    def enhance(self, img_u8) -> np.ndarray:
        """(H, W, 3) u8 -> (H, W, 3) u8 enhanced."""
        img_u8 = np.asarray(img_u8)
        if img_u8.ndim != 3 or img_u8.shape[-1] != 3:
            raise ValueError(f"expected RGB (H,W,3), got {img_u8.shape}")
        return self.enhance_batch(img_u8[None])[0]

    __call__ = enhance

    def enhance_stream(self, frames, depth: int = 2, staging: str = "hwc",
                       workers: int = 1):
        """Streaming enhancement (BASELINE.json config 4): iterate u8 HWC
        frames (or (B,H,W,3) batches); host-side staging and the host->HBM
        copy run double-buffered ahead of device compute via PrefetchQueue.
        Yields enhanced frames/batches as numpy, in order.

        ``staging`` says where the layout work runs:

        * ``"hwc"`` — frames go to the device as-is; the device program
          runs its own transposes (the default contract).
        * ``"planar"`` — the worker converts frames to planar u8 on the
          host; the device runs the transpose-free planar program.

        Output is bit-identical in both modes. ``workers`` sizes the
        staging pool.
        """
        if staging not in ("hwc", "planar"):
            raise ValueError(f"staging must be hwc|planar: {staging!r}")
        import collections

        from low_light_image_enhancement_tpu.io.prefetch import (
            PrefetchQueue,
            from_planar,
            to_planar,
        )

        # (h, w, was_single) per staged item, filled by the source wrapper
        # in iteration order (the prefetch coordinator pulls the source
        # sequentially, so order matches even with a worker pool)
        metas: "collections.deque" = collections.deque()

        def tag(it):
            for f in it:
                a = np.asarray(f)
                single = a.ndim == 3
                if single:
                    a = a[None]
                metas.append((a.shape[1], a.shape[2], single))
                yield a

        def stage(a):
            return to_planar(a) if staging == "planar" else a

        def finish(done, h, w, single):
            res = np.asarray(done)
            if staging == "planar":
                res = from_planar(res)
            return res[0] if single else res

        pending = []
        # device_put=True: the worker thread enqueues the host->HBM copy for
        # frame N+1 while the device computes on frame N (double buffering).
        with PrefetchQueue(tag(frames), depth=depth, transform=stage,
                           device_put=True, workers=workers) as q:
            for item in q:
                h, w, single = metas.popleft()
                if staging == "planar":
                    out = self.enhance_batch_device_planar(item)
                else:
                    out = self.enhance_batch_device(item)
                pending.append((out, h, w, single))
                # keep one batch in flight: overlap device compute with the
                # host fetch of the previous result
                if len(pending) > 1:
                    yield finish(*pending.pop(0))
        for args in pending:
            yield finish(*args)

    def enhance_file(self, in_path: str, out_path: str) -> None:
        from low_light_image_enhancement_tpu.io.codec import (
            decode_image,
            encode_image,
        )

        encode_image(self.enhance(decode_image(in_path)), out_path)

    # ------------------------------------------------------------------ #
    # RAW (Bayer) ingest: ISP front-end fused into the enhance graph
    # ------------------------------------------------------------------ #

    def _compiled_raw(self, b: int, h: int, w: int, wb_gains, ccm,
                      raw_gamma: float, bucketed: bool = False):
        """One jit per (shape, ISP constants): raw mosaic -> ISP -> the
        standard u8 enhance body, a single device program (the intermediate
        planar->HWC->planar transpose pair cancels in XLA's simplifier).
        ``bucketed``: the program takes an extra traced (2,) valid-extent
        arg so gray-world statistics stay on the real pixels of a
        bucket-padded mosaic while every size in the bucket shares one
        compiled program."""
        key = ("raw", b, h, w, wb_gains, ccm, raw_gamma, bucketed)
        fn = self._cache.get(key)
        if fn is None:
            with self._cache_lock:
                fn = self._cache.get(key)
                if fn is not None:
                    return fn
                enhance_body = functools.partial(
                    _enhance_u8_batch,
                    cfg=self.config,
                    use_kernel=self._use_kernel,
                    interpret=self._interpret,
                )

                if bucketed:
                    def run(raws, model_params, valid_hw):
                        imgs_u8 = _isp_u8_hwc(raws, wb_gains, ccm,
                                              raw_gamma, valid_hw)
                        return enhance_body(imgs_u8, model_params)
                else:
                    def run(raws, model_params):
                        imgs_u8 = _isp_u8_hwc(raws, wb_gains, ccm,
                                              raw_gamma)
                        return enhance_body(imgs_u8, model_params)

                fn = jax.jit(run)
                self._cache[key] = fn
        return fn

    def enhance_raw_batch(
        self,
        raws,
        wb_gains=None,
        ccm=None,
        raw_gamma: float = 1.0 / 2.2,
        white_level: Optional[float] = None,
    ) -> np.ndarray:
        """(B, H, W) RGGB Bayer mosaics -> (B, H, W, 3) u8 enhanced.

        The ISP front-end (bilinear demosaic, white balance, CCM, display
        gamma — ``ops.isp``, RAW->sRGB per PAPERS.md:5,7) runs on device in
        the SAME compiled program as the enhancement graph, so RAW captures
        pay one dispatch, not two.

        Args:
          raws: uint16 (scaled by ``white_level``, default 65535; clipped at
            the white level), uint8 (/255), or float in [0, 1]. Other
            integer dtypes raise — int16/int32 RAW containers must be
            converted explicitly (``_load_raw_mosaic`` in cli.py does this
            for non-negative 16-bit-range data), because silently clipping
            integer DNs to [0, 1] would produce an all-white result
            (ADVICE r4, medium). H and W must be even (RGGB tiling).
          wb_gains: (3,) per-channel gains; None -> per-image gray-world
            gains computed on device (on the real image region only).
          ccm: 3x3 color-correction matrix; None -> ``ops.isp.DEFAULT_CCM``.
          raw_gamma: display gamma applied after the CCM (1.0 disables).
          white_level: override the uint16 full-scale value (e.g. 4095 for
            12-bit sensors stored in u16); only meaningful for uint16
            input — raises otherwise.

        ``bucket`` (the constructor field) applies here too: mosaics are
        reflect-padded (even offsets — Bayer-phase-preserving) up to bucket
        multiples before compilation and cropped back, so varying RAW sizes
        hit a bounded number of compiled programs like the RGB path
        (ADVICE r4: the raw path used to bypass the bounded-compile
        contract).
        """
        from low_light_image_enhancement_tpu.ops.isp import DEFAULT_CCM

        raws = np.asarray(raws)
        if raws.ndim != 3:
            raise ValueError(f"expected (B, H, W) Bayer mosaics, "
                             f"got {raws.shape}")
        b, h, w = raws.shape
        if h % 2 or w % 2:
            raise ValueError(f"RGGB mosaic needs even H and W, got {h}x{w}")
        if white_level is not None and raws.dtype != np.uint16:
            raise ValueError(
                f"white_level applies to uint16 mosaics; got {raws.dtype} "
                "(uint8 is always /255, float is taken as already in [0, 1])"
            )
        if raws.dtype == np.uint16:
            scale = float(white_level) if white_level else 65535.0
            # clip at the white level: a 12-bit sensor's occasional DN above
            # white_level must saturate, not skew the gray-world statistics
            raws = np.clip(raws.astype(np.float32) / scale, 0.0, 1.0)
        elif raws.dtype == np.uint8:
            raws = raws.astype(np.float32) / 255.0
        elif np.issubdtype(raws.dtype, np.floating):
            raws = np.clip(raws.astype(np.float32), 0.0, 1.0)
        else:
            raise ValueError(
                f"unsupported mosaic dtype {raws.dtype}: use uint16 (with "
                "white_level for sub-16-bit sensors), uint8, or float in "
                "[0, 1]; integer RAW containers (int16/int32) must be "
                "converted explicitly so DNs aren't clipped to [0, 1]"
            )
        valid_hw = None
        if self.bucket:
            g = self.bucket + self.bucket % 2  # even: preserves RGGB phase
            hb, wb_ = -(-h // g) * g, -(-w // g) * g
            if (hb, wb_) != (h, w):
                raws = np.pad(
                    raws, ((0, 0), (0, hb - h), (0, wb_ - w)),
                    mode="reflect",  # even-offset mirror keeps Bayer phase
                )
                valid_hw = (h, w)
        bh, bw = raws.shape[1:]
        wb_key = None if wb_gains is None else tuple(
            float(g) for g in np.asarray(wb_gains).reshape(-1)
        )
        ccm_key = tuple(
            tuple(float(v) for v in row)
            for row in np.asarray(DEFAULT_CCM if ccm is None else ccm)
        )
        bucketed = valid_hw is not None
        extent = (jnp.asarray(valid_hw, jnp.int32),) if bucketed else ()
        if self.config.spatial_shards > 1 or self.config.data_shards > 1:
            # Sharded configs keep their own dispatch (halo exchange / batch
            # placement): run the ISP stage as its own small program, then
            # route the u8 result through the standard sharded entry point.
            srgb = self._compiled_isp(b, bh, bw, wb_key, ccm_key,
                                      float(raw_gamma), bucketed)(
                jnp.asarray(raws), *extent)
            out = self.enhance_batch(np.asarray(srgb))
            return out[:, :h, :w] if bucketed else out
        fn = self._compiled_raw(b, bh, bw, wb_key, ccm_key, float(raw_gamma),
                                bucketed)
        out = np.asarray(fn(jnp.asarray(raws), self.model_params, *extent))
        return out[:, :h, :w] if bucketed else out

    def _compiled_isp(self, b: int, h: int, w: int, wb_gains, ccm,
                      raw_gamma: float, bucketed: bool = False):
        """ISP-only program: (B, H, W) f32 mosaic -> (B, H, W, 3) u8 sRGB.
        With ``bucketed``, takes a traced (2,) valid-extent second arg."""
        key = ("isp", b, h, w, wb_gains, ccm, raw_gamma, bucketed)
        fn = self._cache.get(key)
        if fn is None:
            with self._cache_lock:
                fn = self._cache.get(key)
                if fn is not None:
                    return fn
                if bucketed:
                    def run(raws, valid_hw):
                        return _isp_u8_hwc(raws, wb_gains, ccm, raw_gamma,
                                           valid_hw)
                else:
                    def run(raws):
                        return _isp_u8_hwc(raws, wb_gains, ccm, raw_gamma)
                fn = jax.jit(run)
                self._cache[key] = fn
        return fn

    def enhance_raw(self, raw, **kwargs) -> np.ndarray:
        """(H, W) RGGB Bayer mosaic -> (H, W, 3) u8 enhanced RGB.
        See ``enhance_raw_batch`` for dtype/kwarg semantics."""
        raw = np.asarray(raw)
        if raw.ndim != 2:
            raise ValueError(f"expected (H, W) Bayer mosaic, got {raw.shape}")
        return self.enhance_raw_batch(raw[None], **kwargs)[0]


# ---------------------------------------------------------------------- #
# Module-level convenience API (BASELINE.json: "enhance(image)->image")
# ---------------------------------------------------------------------- #

_default_pipeline: Optional[EnhancePipeline] = None


def _default() -> EnhancePipeline:
    global _default_pipeline
    if _default_pipeline is None:
        _default_pipeline = EnhancePipeline()
    return _default_pipeline


def enhance(img_u8) -> np.ndarray:
    """Enhance a single u8 HWC RGB image with the default config."""
    return _default().enhance(img_u8)


def enhance_batch(imgs_u8) -> np.ndarray:
    """Enhance a u8 BHWC RGB batch with the default config."""
    return _default().enhance_batch(imgs_u8)
