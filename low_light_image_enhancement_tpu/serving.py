"""Micro-batching enhancement server (production serving surface).

``EnhanceServer`` accepts single-image requests from any number of threads,
coalesces them into device batches (grouped by bucketed shape), runs the
compiled pipeline once per batch, and resolves per-request futures. This is
the serving-side counterpart of the throughput-oriented batch API: callers
get single-image latency ~= batch latency while the chip stays batched.

Design notes:
  * a single dispatcher thread owns the device — no cross-thread jit races
    on the hot path;
  * shape bucketing bounds the number of compiled programs per image shape,
    and batch sizes are bucketed too (1, 4, 16, ..., max_batch) so dynamic
    group sizes don't thrash the jit cache;
  * ``max_batch`` bounds HBM per dispatch and is enforced PER shape group —
    one oversized group never starves another;
  * ``max_delay_ms`` bounds queueing latency when traffic is sparse;
  * cold shapes compile on a background thread: a first-ever 4K request
    compiles for ~seconds WITHOUT stalling warm 600x400 traffic (XLA
    compilation is host-side work; the dispatcher keeps running other
    groups meanwhile). Requests for the cold shape wait only for their own
    compile.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from low_light_image_enhancement_tpu.config import PipelineConfig
from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

ShapeKey = Tuple[int, int]


class ServerSaturated(RuntimeError):
    """Raised by ``submit`` when ``max_queue`` is reached under the
    ``overflow='reject'`` policy."""


class EnhanceServer:
    def __init__(
        self,
        config: PipelineConfig = PipelineConfig(),
        pipeline: Optional[EnhancePipeline] = None,
        max_batch: int = 32,
        max_delay_ms: float = 5.0,
        bucket: int = 64,
        max_queue: Optional[int] = None,
        overflow: str = "block",
    ):
        """``max_queue``: bound on in-flight requests (queued + batching +
        dispatched). ``overflow``: what a full server does to ``submit`` —
        ``"block"`` (backpressure the producer until capacity frees) or
        ``"reject"`` (raise :class:`ServerSaturated` immediately). ``None``
        keeps the round-2 unbounded behavior."""
        if overflow not in ("block", "reject"):
            raise ValueError(
                f"overflow must be 'block' or 'reject': {overflow!r}"
            )
        self._pipe = pipeline or EnhancePipeline(config, bucket=bucket)
        if getattr(self._pipe, "bucket", None) is None:
            self._pipe.bucket = bucket
        self._bucket = self._pipe.bucket
        self._max_batch = max_batch
        self._max_delay = max_delay_ms / 1000.0
        # geometric batch buckets bound compiles to O(log max_batch) programs
        # per shape while wasting <4x padding compute in the worst case.
        # Under DP serving (config.data_shards > 1) every dispatched batch
        # must divide over the data mesh, so buckets start at data_shards
        # (the pipeline has already refused a host with fewer devices).
        dshards = getattr(
            getattr(self._pipe, "config", None), "data_shards", 1
        )
        top = -(-max_batch // dshards) * dshards  # round up to a multiple
        self._batch_buckets = []
        b = max(1, dshards)
        while b < top:
            self._batch_buckets.append(b)
            b *= 4
        self._batch_buckets.append(top)
        self._q: "queue.Queue" = queue.Queue()
        # request-capacity bound: acquired per submit, released when the
        # request's Future resolves (every path — result, error, close-drain
        # — resolves each future exactly once)
        self._capacity = (
            threading.BoundedSemaphore(max_queue) if max_queue else None
        )
        self._overflow = overflow
        self._stop = threading.Event()
        # serializes submit-vs-close so a request can't slip into the queue
        # after close() drains it (its Future would never resolve)
        self._submit_lock = threading.Lock()
        # per-shape pending items + arrival time of the oldest pending item
        self._pending: Dict[ShapeKey, List] = {}
        self._since: Dict[ShapeKey, float] = {}
        # warm (compiled) (b_pad, h, w) programs; guarded by _warm_lock
        # because background compile threads add to it
        self._warm: set = set()
        self._compiling: Dict[Tuple[int, int, int], threading.Thread] = {}
        self._warm_lock = threading.Lock()
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- public #

    def submit(self, img_u8: np.ndarray) -> "Future[np.ndarray]":
        """Queue one (H, W, 3) u8 image; returns a Future of the result."""
        img_u8 = np.asarray(img_u8)
        if img_u8.ndim != 3 or img_u8.shape[-1] != 3:
            raise ValueError(f"expected RGB (H,W,3), got {img_u8.shape}")
        if self._capacity is not None:
            # acquire BEFORE _submit_lock so a blocked producer can't hold
            # the lock against close(); pairs with exactly one release via
            # the future's done-callback
            if not self._capacity.acquire(
                blocking=self._overflow == "block"
            ):
                raise ServerSaturated(
                    "server at max_queue in-flight requests "
                    "(overflow='reject')"
                )
        fut: "Future[np.ndarray]" = Future()
        if self._capacity is not None:
            fut.add_done_callback(lambda _f: self._capacity.release())
        with self._submit_lock:
            if self._stop.is_set():
                if not fut.done():
                    fut.cancel()  # fires the callback -> capacity released
                raise RuntimeError("server closed")
            self._q.put((img_u8, fut))
        return fut

    def enhance(self, img_u8: np.ndarray) -> np.ndarray:
        """Blocking convenience call."""
        return self.submit(img_u8).result()

    def close(self, timeout: float = 600.0) -> None:
        with self._submit_lock:
            self._stop.set()
        # Normal path: the dispatcher drains every pending and queued request
        # (compiling synchronously if it must) before exiting, so no Future
        # is left unresolved. The bounded join + drain below is the safety
        # net for a dispatcher that died (it fails its own futures on fatal
        # errors, but belt-and-braces) or hung in a device call: everything
        # still unresolved is failed, with done() guards so nothing is
        # double-resolved.
        self._thread.join(timeout=timeout)
        err = RuntimeError(
            "server closed with the dispatcher "
            + ("hung" if self._thread.is_alive() else "dead")
        )
        try:
            while True:
                _, fut = self._q.get_nowait()
                if not fut.done():
                    fut.set_exception(err)
        except queue.Empty:
            pass
        for items in list(self._pending.values()):
            for _, fut in list(items):
                if not fut.done():
                    try:
                        fut.set_exception(err)
                    except Exception:
                        pass  # lost a race with a late set_result

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------- dispatch #

    def _key(self, img: np.ndarray) -> ShapeKey:
        g = self._bucket
        h, w, _ = img.shape
        return (-(-h // g) * g, -(-w // g) * g)

    def _b_pad(self, n: int) -> int:
        for b in self._batch_buckets:
            if b >= n:
                return b
        return self._max_batch

    def _add(self, item) -> None:
        key = self._key(item[0])
        if key not in self._pending or not self._pending[key]:
            self._since[key] = time.monotonic()
        self._pending.setdefault(key, []).append(item)

    def _warm_key(self, n: int, key: ShapeKey) -> Tuple[int, int, int]:
        return (self._b_pad(n), key[0], key[1])

    def _compile(self, wkey: Tuple[int, int, int]) -> None:
        """Background warm-up of one (b_pad, h, w) program. Errors are
        swallowed here — the dispatch that uses the program reports them on
        the affected futures."""
        b, h, w = wkey
        try:
            self._pipe.warmup([(b, h, w)])
        except Exception:
            pass
        finally:
            # mark warm even on error — INCLUDING BaseException, hence the
            # finally: dispatch must proceed and surface the real exception
            # on the requests' futures instead of starving the group behind
            # a dead compile thread
            with self._warm_lock:
                self._warm.add(wkey)
                self._compiling.pop(wkey, None)

    def _ensure_warm(self, wkey: Tuple[int, int, int]) -> bool:
        """True when the program is ready; kicks off a background compile
        otherwise."""
        with self._warm_lock:
            if wkey in self._warm:
                return True
            if wkey not in self._compiling:
                t = threading.Thread(
                    target=self._compile, args=(wkey,), daemon=True
                )
                self._compiling[wkey] = t
                t.start()
            return False

    def _have_work(self) -> bool:
        return any(self._pending.values()) or not self._q.empty()

    def _dispatch(self) -> None:
        try:
            self._dispatch_loop()
        except BaseException as e:  # dispatcher must never die silently:
            # fail every outstanding future so callers unblock (close()'s
            # drain is the second net for anything racing in)
            for items in list(self._pending.values()):
                for _, fut in list(items):
                    if not fut.done():
                        fut.set_exception(e)
            raise

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set() or self._have_work():
            # pull new arrivals (block briefly only when nothing is pending)
            timeout = 0.002 if any(self._pending.values()) else 0.05
            try:
                self._add(self._q.get(timeout=timeout))
                while True:
                    self._add(self._q.get_nowait())
            except queue.Empty:
                pass
            closing = self._stop.is_set()
            now = time.monotonic()
            for key in list(self._pending):
                items = self._pending[key]
                if not items:
                    continue
                full = len(items) >= self._max_batch
                due = now - self._since[key] >= self._max_delay
                if not (full or due or closing):
                    continue
                n = min(len(items), self._max_batch)
                b_target = self._b_pad(n)
                # At close, skip the background-compile machinery entirely:
                # _run_group compiles synchronously, and spawning a warmup
                # thread here would duplicate that compile and race it.
                if not closing and not self._ensure_warm(
                    (b_target, *key)
                ):
                    # cold program: its compile runs in the background; keep
                    # this group progressing on any already-warm bucket for
                    # the shape — the smallest warm bucket that fits all n
                    # (padding up wastes a little compute but serves NOW),
                    # else the largest warm bucket below n (partial batch)
                    with self._warm_lock:
                        warm_up = [b for b in self._batch_buckets
                                   if b >= n and (b, *key) in self._warm]
                        warm_dn = [b for b in self._batch_buckets
                                   if b < n and (b, *key) in self._warm]
                    if not warm_up and not warm_dn:
                        continue
                    b_target = warm_up[0] if warm_up else warm_dn[-1]
                    n = min(n, b_target)
                take, rest = items[:n], items[n:]
                self._pending[key] = rest
                if rest:
                    self._since[key] = now
                self._run_group(key[0], key[1], take, b_target)

    def _run_group(
        self, hb: int, wb: int, items: List, b_pad: Optional[int] = None
    ) -> None:
        try:
            padded = np.stack([
                np.pad(
                    img,
                    ((0, hb - img.shape[0]), (0, wb - img.shape[1]), (0, 0)),
                    mode="edge",
                )
                for img, _ in items
            ])
            if b_pad is None:
                b_pad = self._b_pad(len(items))
            if b_pad > len(items):
                # replicate the last image up to the batch bucket so batch
                # sizes hit a bounded set of compiled programs
                padded = np.concatenate(
                    [padded,
                     np.repeat(padded[-1:], b_pad - len(items), axis=0)]
                )
            # bucket-padding already applied; call the exact-shape path
            out = np.asarray(self._pipe.enhance_batch_device(padded))
            for (img, fut), res in zip(items, out):
                h, w, _ = img.shape
                if not fut.done():
                    fut.set_result(res[:h, :w])
        except BaseException as e:
            for _, fut in items:
                if not fut.done():
                    fut.set_exception(e)
            if not isinstance(e, Exception):
                # fatal (SystemExit/KeyboardInterrupt-class): this group's
                # futures are failed above; re-raise so _dispatch's handler
                # fails everything still pending and the thread exits
                raise
