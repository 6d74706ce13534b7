"""The zlib + numpy PNG codec (io.codec): round trips, and against Pillow
(an optional dependency; those cases skip without it) on Pillow-written
files with every filter type and on the repo's fixtures; the errors."""

import io
from pathlib import Path

import numpy as np
import pytest

from low_light_image_enhancement_tpu.io.codec import (
    decode_image,
    decode_png,
    encode_image,
    encode_png,
)

DATA = Path(__file__).resolve().parents[1] / "data"
RNG = np.random.default_rng(0)


@pytest.fixture
def Image():  # noqa: N802 - the module it stands for
    return pytest.importorskip("PIL.Image")


def _smooth(h, w, c):
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 3 + y * 2)[..., None] + np.arange(c) * 40
    return (base % 256).astype(np.uint8)


CASES = {
    "rgb_noise": RNG.integers(0, 256, (17, 23, 3), dtype=np.uint8),
    "rgb_smooth": _smooth(31, 40, 3),
    "rgba": RNG.integers(0, 256, (9, 12, 4), dtype=np.uint8),
    "gray": _smooth(20, 33, 1)[..., 0],
    "gray_alpha": RNG.integers(0, 256, (8, 8, 2), dtype=np.uint8),
    "gray16": RNG.integers(0, 65536, (14, 18), dtype=np.uint16),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_roundtrip(name):
    img = CASES[name]
    got = decode_png(encode_png(img))
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("name", ["rgb_noise", "rgb_smooth", "rgba",
                                  "gray", "gray16"])
def test_decodes_pillow_files(name, Image):
    """Pillow picks filters per row (Average and Paeth included)."""
    img = CASES[name]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    np.testing.assert_array_equal(decode_png(buf.getvalue()), img)


def test_pillow_reads_our_files(Image):
    img = CASES["rgb_smooth"]
    with Image.open(io.BytesIO(encode_png(img))) as im:
        np.testing.assert_array_equal(np.asarray(im), img)


@pytest.mark.parametrize("name", sorted(p.name for p in DATA.glob("*.png")))
def test_fixtures_match_pillow(name, Image):
    with Image.open(DATA / name) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(decode_image(DATA / name), want)


def test_decode_image_to_rgb():
    gray = CASES["gray"]
    np.testing.assert_array_equal(decode_image(encode_png(gray)),
                                  np.repeat(gray[..., None], 3, axis=-1))
    rgba = CASES["rgba"]
    np.testing.assert_array_equal(decode_image(encode_png(rgba)),
                                  rgba[..., :3])


def test_encode_image_writes_png_by_extension(tmp_path):
    img = CASES["rgb_noise"]
    encode_image(img, tmp_path / "x.png")
    np.testing.assert_array_equal(decode_image(tmp_path / "x.png"), img)


def test_errors():
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a....")
    with pytest.raises(ValueError, match="uint8 or uint16"):
        encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="gray images only"):
        encode_png(np.zeros((4, 4, 3), np.uint16))
