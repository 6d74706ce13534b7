"""Multi-worker decode pool: ordering preserved, decode actually parallel,
errors propagate."""

import threading
import time

import pytest

from low_light_image_enhancement_tpu.io.prefetch import PrefetchQueue


def test_workers_preserve_order():
    def slow_transform(i):
        time.sleep(0.01 * ((i * 7) % 3))  # jittered latency
        return i * 10

    q = PrefetchQueue(range(30), depth=4, transform=slow_transform,
                      device_put=False, workers=4)
    assert list(q) == [i * 10 for i in range(30)]


def test_workers_actually_parallel():
    barrier = threading.Barrier(3, timeout=5)

    def transform(i):
        if i < 3:
            barrier.wait()  # deadlocks unless >= 3 transforms run at once
        return i

    q = PrefetchQueue(range(8), depth=8, transform=transform,
                      device_put=False, workers=4)
    assert list(q) == list(range(8))


def test_workers_error_propagates():
    def transform(i):
        if i == 5:
            raise ValueError("bad decode")
        return i

    q = PrefetchQueue(range(10), depth=2, transform=transform,
                      device_put=False, workers=3)
    got = []
    with pytest.raises(ValueError, match="bad decode"):
        for x in q:
            got.append(x)
    assert got == [0, 1, 2, 3, 4]


def test_workers_validation():
    with pytest.raises(ValueError):
        PrefetchQueue([1], workers=0)


@pytest.mark.skipif((__import__("os").cpu_count() or 1) < 4,
                    reason="decode scaling needs >= 4 CPUs")
def test_decode_throughput_scales(tmp_path):
    """Throughput with 4 workers should beat 1 worker on a GIL-releasing
    decode workload (PNG: zlib's inflate releases the GIL). The image is a
    compressible 800x1200 frame: a small or incompressible one decodes
    faster than the pool hands out work, and would time the pool."""
    from low_light_image_enhancement_tpu.data.synth import synth_pair
    from low_light_image_enhancement_tpu.io.codec import decode_image, encode_image

    _, img = synth_pair(0, 800, 1200)
    blob = encode_image(img, format="PNG")
    blobs = [blob] * 40

    def run(workers):
        t0 = time.perf_counter()
        for _ in PrefetchQueue(iter(blobs), depth=4, transform=decode_image,
                               device_put=False, workers=workers):
            pass
        return time.perf_counter() - t0

    run(4)  # warm the pool/page cache
    t1, t4 = run(1), run(4)
    # demand only a modest speedup to stay robust on loaded CI machines
    assert t4 < t1 * 0.9, (t1, t4)
