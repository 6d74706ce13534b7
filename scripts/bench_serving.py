#!/usr/bin/env python
"""Dispatcher-overhead benchmark for EnhanceServer.

Measures the DISPATCHER's own cost: this harness replaces the pipeline with
an instant fake device (optionally with a fixed per-dispatch device cost
and a cold-compile cost), so what remains is: queueing, grouping, padding,
batch-bucketing, future resolution.

One JAX process per card: the harness, its submitter threads and the HTTP
front-end all run in this one process (threads, never a second process),
because a JAX process reserves most of a card's memory when it starts and
a second one on the same card fails.

Scenarios:
  warm      : single shape, warm program, N submitter threads
  mixed     : 3 shape buckets round-robin
  coldstorm : mixed + a never-before-seen shape every 50 requests

Prints one summary line per scenario: sustained req/s, p50/p99 latency.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from low_light_image_enhancement_tpu.serving import EnhanceServer  # noqa: E402


class _InstantPipe:
    """Identity device with optional fixed dispatch cost + cold compile."""

    def __init__(self, dispatch_s=0.0, compile_s=0.0):
        self.bucket = 64
        self._dispatch_s = dispatch_s
        self._compile_s = compile_s
        self._seen = set()
        self._lock = threading.Lock()
        self.dispatches = 0

    def warmup(self, shapes):
        for b, h, w in shapes:
            self.enhance_batch_device(np.zeros((b, h, w, 3), np.uint8))

    def enhance_batch_device(self, imgs):
        with self._lock:
            cold = imgs.shape not in self._seen
            self._seen.add(imgs.shape)
            self.dispatches += 1
        if cold and self._compile_s:
            time.sleep(self._compile_s)
        if self._dispatch_s:
            time.sleep(self._dispatch_s)
        return imgs


def run_scenario(name, shapes_fn, n_requests=2000, n_threads=8,
                 dispatch_s=0.0, compile_s=0.0, max_batch=32):
    pipe = _InstantPipe(dispatch_s=dispatch_s, compile_s=compile_s)
    srv = EnhanceServer(pipeline=pipe, max_delay_ms=2.0,
                        max_batch=max_batch, max_queue=4 * max_batch)
    latencies = []
    lat_lock = threading.Lock()
    idx = {"v": 0}

    def worker():
        while True:
            with lat_lock:
                i = idx["v"]
                if i >= n_requests:
                    return
                idx["v"] += 1
            img = np.zeros((*shapes_fn(i), 3), np.uint8)
            t0 = time.monotonic()
            srv.enhance(img)
            dt = time.monotonic() - t0
            with lat_lock:
                latencies.append(dt)

    # warm the programs outside the timed window
    warm_shapes = {shapes_fn(i) for i in range(120)}
    for h, w in warm_shapes:
        srv.enhance(np.zeros((h, w, 3), np.uint8))

    t0 = time.monotonic()
    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    srv.close()
    lat = np.sort(np.array(latencies))
    print(
        f"{name:10s} {n_requests / wall:9.0f} req/s  "
        f"p50 {lat[len(lat) // 2] * 1e3:6.2f} ms  "
        f"p99 {lat[int(len(lat) * 0.99)] * 1e3:6.2f} ms  "
        f"dispatches {pipe.dispatches} "
        f"({n_requests / max(1, pipe.dispatches):.1f} req/dispatch)"
    )


def run_http_scenario(name, n_requests=2000, n_threads=8, shape=(40, 60)):
    """Same warm single-shape workload through the HTTP front-end
    (http_server.py): the delta vs the 'warm' scenario isolates the
    socket + HTTP parse + PNG decode/encode cost per request."""
    import http.client

    from low_light_image_enhancement_tpu.http_server import HttpEnhanceServer
    from low_light_image_enhancement_tpu.io.codec import encode_image

    pipe = _InstantPipe()
    backend = EnhanceServer(pipeline=pipe, max_delay_ms=2.0,
                            max_batch=32, max_queue=128)
    srv = HttpEnhanceServer(host="127.0.0.1", port=0,
                            enhance_server=backend).start()
    body = encode_image(np.zeros((*shape, 3), np.uint8), format="PNG")
    latencies = []
    lat_lock = threading.Lock()
    idx = {"v": 0}

    def worker():
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
        try:
            while True:
                with lat_lock:
                    if idx["v"] >= n_requests:
                        return
                    idx["v"] += 1
                t0 = time.monotonic()
                conn.request("POST", "/enhance", body=body,
                             headers={"Content-Length": str(len(body))})
                r = conn.getresponse()
                r.read()
                assert r.status == 200, r.status
                dt = time.monotonic() - t0
                with lat_lock:
                    latencies.append(dt)
        finally:
            conn.close()

    # warm the program + a first HTTP round trip outside the timed window
    c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
    c.request("POST", "/enhance", body=body,
              headers={"Content-Length": str(len(body))})
    c.getresponse().read()
    c.close()

    t0 = time.monotonic()
    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    srv.close()
    backend.close()
    lat = np.sort(np.array(latencies))
    print(
        f"{name:10s} {n_requests / wall:9.0f} req/s  "
        f"p50 {lat[len(lat) // 2] * 1e3:6.2f} ms  "
        f"p99 {lat[int(len(lat) * 0.99)] * 1e3:6.2f} ms  "
        f"dispatches {pipe.dispatches} "
        f"({n_requests / max(1, pipe.dispatches):.1f} req/dispatch)"
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()

    mixed_shapes = [(40, 60), (100, 130), (170, 200)]
    print(f"requests={args.requests} threads={args.threads} "
          "(instant fake device: pure dispatcher cost)")
    run_scenario("warm", lambda i: (40, 60),
                 n_requests=args.requests, n_threads=args.threads)
    run_scenario("mixed", lambda i: mixed_shapes[i % 3],
                 n_requests=args.requests, n_threads=args.threads)
    run_scenario(
        "coldstorm",
        lambda i: (64 + 64 * (i // 50), 64) if i % 50 == 0
        else mixed_shapes[i % 3],
        n_requests=args.requests, n_threads=args.threads, compile_s=0.2,
    )
    # device-cost variant: 1 ms per dispatch models a device's batch time
    run_scenario("warm+1ms", lambda i: (40, 60),
                 n_requests=args.requests, n_threads=args.threads,
                 dispatch_s=0.001)
    # same warm workload through the HTTP front-end (llie serve)
    run_http_scenario("http", n_requests=args.requests,
                      n_threads=args.threads)


if __name__ == "__main__":
    main()
