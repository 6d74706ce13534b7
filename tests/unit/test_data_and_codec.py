import numpy as np

from low_light_image_enhancement_tpu.data.lol import LOLDataset
from low_light_image_enhancement_tpu.data.synth import synth_batch, synth_pair
from low_light_image_enhancement_tpu.io.codec import decode_image, encode_image


def test_synth_pair_deterministic_and_dark():
    low1, high1 = synth_pair(3, 32, 48)
    low2, high2 = synth_pair(3, 32, 48)
    np.testing.assert_array_equal(low1, low2)
    np.testing.assert_array_equal(high1, high2)
    assert low1.shape == (32, 48, 3) and low1.dtype == np.uint8
    assert low1.astype(np.float64).mean() < high1.astype(np.float64).mean() * 0.5


def test_synth_batch_shapes():
    lows, highs = synth_batch(4, 16, 24)
    assert lows.shape == highs.shape == (4, 16, 24, 3)


def test_lol_dataset_synthetic_fallback(tmp_path):
    ds = LOLDataset(root=str(tmp_path / "nope"), split="eval15", size=(32, 48))
    assert ds.is_synthetic and len(ds) == 15
    low, high, name = ds[0]
    assert low.shape == (32, 48, 3) and "synth" in name
    lows, highs = ds.as_batch(4)
    assert lows.shape == (4, 32, 48, 3)


def test_lol_dataset_reads_real_layout(tmp_path):
    root = tmp_path / "LOL"
    for sub in ("low", "high"):
        (root / "eval15" / sub).mkdir(parents=True)
    img = np.random.default_rng(0).integers(0, 255, (8, 8, 3), dtype=np.uint8)
    for sub in ("low", "high"):
        encode_image(img, root / "eval15" / sub / "1.png")
    ds = LOLDataset(root=str(root), split="eval15")
    assert not ds.is_synthetic and len(ds) == 1
    low, high, name = ds[0]
    np.testing.assert_array_equal(low, img)
    assert name == "1.png"


def test_codec_png_roundtrip(tmp_path):
    img = np.random.default_rng(1).integers(0, 255, (20, 30, 3), dtype=np.uint8)
    p = tmp_path / "x.png"
    encode_image(img, p)
    np.testing.assert_array_equal(decode_image(p), img)
    # bytes roundtrip
    data = encode_image(img, format="PNG")
    np.testing.assert_array_equal(decode_image(data), img)


def test_codec_jpeg_lossy_close(tmp_path):
    import pytest

    pytest.importorskip("PIL")  # JPEG goes through the optional Pillow
    img = np.full((32, 32, 3), 128, dtype=np.uint8)
    data = encode_image(img, format="JPEG", quality=95)
    out = decode_image(data)
    assert np.abs(out.astype(int) - 128).max() < 6


def test_lol_train_batches_stream():
    """Dataset-backed training batches: shapes, range, paired/unpaired,
    and per-step determinism (the resume contract: start_step=k yields
    the same batch a straight run yields at step k)."""
    from low_light_image_enhancement_tpu.data.lol import LOLDataset

    ds = LOLDataset(split="eval15", size=(40, 64))
    it = ds.train_batches(batch_size=2, crop=24, seed=7)
    low, high = next(it)
    assert low.shape == high.shape == (2, 3, 24, 24)
    assert low.dtype == np.float32 and 0.0 <= low.min() <= low.max() <= 1.0
    b1 = next(it)

    resumed = ds.train_batches(batch_size=2, crop=24, seed=7, start_step=1)
    r1 = next(resumed)
    np.testing.assert_array_equal(b1[0], r1[0])
    np.testing.assert_array_equal(b1[1], r1[1])

    lows_only = next(ds.train_batches(batch_size=2, crop=24, paired=False))
    assert lows_only.shape == (2, 3, 24, 24)

    # the worker-pool composition (plans -> materialize in a PrefetchQueue)
    # yields the identical stream to the serial train_batches
    from low_light_image_enhancement_tpu.io.prefetch import PrefetchQueue

    serial = ds.train_batches(batch_size=2, crop=24, seed=7)
    with PrefetchQueue(
        ds.train_batch_plans(batch_size=2, crop=24, seed=7),
        transform=ds.materialize_batch, workers=3, device_put=False,
    ) as pooled:
        for _ in range(3):
            s_low, s_high = next(serial)
            p_low, p_high = next(pooled)
            np.testing.assert_array_equal(s_low, p_low)
            np.testing.assert_array_equal(s_high, p_high)
