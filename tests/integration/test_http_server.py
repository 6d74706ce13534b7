"""HTTP serving surface (`llie serve` / http_server.HttpEnhanceServer):
bytes-in/bytes-out round trip over a real socket, error statuses, and the
saturation path mapping ServerSaturated -> 503."""

import http.client
import threading
import time

import numpy as np

from low_light_image_enhancement_tpu.data.synth import synth_pair
from low_light_image_enhancement_tpu.http_server import HttpEnhanceServer
from low_light_image_enhancement_tpu.io.codec import decode_image, encode_image
from low_light_image_enhancement_tpu.serving import EnhanceServer


def _post(port, body, path="/enhance"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Length": str(len(body))})
        r = conn.getresponse()
        return r.status, r.read(), r.getheader("Content-Type")
    finally:
        conn.close()


def test_http_roundtrip_and_errors():
    low, _ = synth_pair(0, 40, 64)
    srv = HttpEnhanceServer(host="127.0.0.1", port=0,
                            max_delay_ms=1.0).start()
    try:
        # healthz
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 200
        conn.close()

        # PNG in -> PNG out, same shape, actually enhanced
        status, body, ctype = _post(srv.port, encode_image(low, format="PNG"))
        assert status == 200 and ctype == "image/png"
        out = decode_image(body)
        assert out.shape == low.shape and out.dtype == np.uint8
        assert out.astype(np.int64).mean() > low.astype(np.int64).mean()

        # JPEG in -> JPEG out (JPEG goes through the optional Pillow)
        import importlib.util

        if importlib.util.find_spec("PIL") is not None:
            status, body, ctype = _post(
                srv.port, encode_image(low, format="JPEG"))
            assert status == 200 and ctype == "image/jpeg"
            assert decode_image(body).shape == low.shape

        # non-image body -> 400
        status, _, _ = _post(srv.port, b"definitely not an image")
        assert status == 400

        # unknown path -> 404
        status, _, _ = _post(srv.port, b"x", path="/nope")
        assert status == 404

        # stats reflect the traffic above
        import json

        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
        assert stats["requests_by_status"]["200"] >= 3  # healthz + 2 enhances
        assert stats["requests_by_status"]["400"] >= 1
        assert stats["enhance_latency_ms"]["p50"] > 0
    finally:
        srv.close()


class _SlowPipe:
    """Identity pipeline with a fixed per-dispatch device cost, to hold
    requests in flight long enough to saturate a max_queue=1 server."""

    bucket = 64

    def warmup(self, shapes):
        pass

    def enhance_batch_device(self, imgs):
        time.sleep(0.2)
        return np.asarray(imgs)


def test_http_saturation_maps_to_503():
    backend = EnhanceServer(pipeline=_SlowPipe(), max_delay_ms=1.0,
                            max_queue=1, overflow="reject")
    srv = HttpEnhanceServer(host="127.0.0.1", port=0,
                            enhance_server=backend).start()
    low, _ = synth_pair(0, 32, 48)
    png = encode_image(low, format="PNG")
    statuses = []
    lock = threading.Lock()

    def worker():
        s, _, _ = _post(srv.port, png)
        with lock:
            statuses.append(s)

    try:
        threads = [threading.Thread(target=worker) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        srv.close()
        backend.close()
    assert statuses and set(statuses) <= {200, 503}
    assert 503 in statuses, statuses  # capacity 1 + 6 bursts must shed load
    assert 200 in statuses, statuses  # but not shed everything


def test_cli_serve_sigterm_drains(tmp_path):
    """`llie serve` exits 0 on SIGTERM after serving traffic (the normal
    orchestrator stop path)."""
    import os
    import re
    import signal
    import subprocess
    import sys
    import textwrap

    env = dict(os.environ)
    code = textwrap.dedent("""
        import jax
        jax.config.update("jax_platforms", "cpu")
        from low_light_image_enhancement_tpu.cli import main
        raise SystemExit(main(["serve", "--port", "0"]))
    """)
    proc = subprocess.Popen(
        [sys.executable, "-c", code], env=env, cwd="/root/repo",
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        line = proc.stdout.readline()
        port = int(re.search(r":(\d+) ", line).group(1))
        low, _ = synth_pair(0, 32, 48)
        status, _, _ = _post(port, encode_image(low, format="PNG"))
        assert status == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_http_error_paths_keep_connection_usable():
    """A 404/400 with an unread body must not desync the keep-alive
    connection: the next request on the same socket still works (the
    handler closes the connection instead of leaving body bytes)."""
    low, _ = synth_pair(0, 32, 48)
    png = encode_image(low, format="PNG")
    srv = HttpEnhanceServer(host="127.0.0.1", port=0,
                            max_delay_ms=1.0).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=120)
        conn.request("POST", "/nope", body=b"x" * 4096,
                     headers={"Content-Length": "4096"})
        r = conn.getresponse()
        assert r.status == 404
        r.read()
        # server signalled close; reconnect and verify normal service
        conn.close()
        status, _, _ = _post(srv.port, png)
        assert status == 200
    finally:
        srv.close()


class _BoomPipe:
    bucket = 64

    def warmup(self, shapes):
        pass

    def enhance_batch_device(self, imgs):
        raise RuntimeError("device exploded")


def test_http_backend_failure_maps_to_500():
    backend = EnhanceServer(pipeline=_BoomPipe(), max_delay_ms=1.0)
    srv = HttpEnhanceServer(host="127.0.0.1", port=0,
                            enhance_server=backend).start()
    low, _ = synth_pair(0, 32, 48)
    try:
        status, body, _ = _post(srv.port, encode_image(low, format="PNG"))
        assert status == 500 and b"enhance failed" in body
    finally:
        srv.close()
        backend.close()
