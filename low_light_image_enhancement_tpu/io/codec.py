"""Image codec (host side).

PNG is decoded and encoded here with ``zlib`` and numpy alone: 8-bit gray,
gray+alpha, RGB and RGBA, and 16-bit gray (RAW mosaics), non-interlaced.
JPEG and every other format go through Pillow, imported only when such a
file is met. Spec: BASELINE.json north_star ("host-side JPEG/PNG decode").
"""

from __future__ import annotations

import io as _io
import os
import struct
import zlib
from typing import Optional, Union

import numpy as np

Source = Union[str, os.PathLike, bytes, bytearray, _io.BytesIO]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def _read_bytes(src: Source) -> bytes:
    if isinstance(src, (bytes, bytearray)):
        return bytes(src)
    if isinstance(src, _io.BytesIO):
        return src.getvalue()
    with open(src, "rb") as f:
        return f.read()


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "only PNG is decoded and encoded without Pillow; install the "
            "'pillow' package for JPEG and other formats"
        ) from e
    return Image


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters -> (h, stride) uint8."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError("truncated PNG image data")
    data = data.reshape(h, stride + 1)
    kinds = data[:, 0]
    if np.all(kinds == 1):
        # Sub on every row (what encode_png writes): one vectorised running
        # sum, which wraps mod 256 in uint8
        rows = data[:, 1:].reshape(h, -1, bpp)
        return np.cumsum(rows, axis=1, dtype=np.uint8).reshape(h, stride)
    if np.all(kinds == 0):
        return data[:, 1:]
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        kind, row = data[y, 0], data[y, 1:].astype(np.int32)
        if kind == 0:
            cur = row
        elif kind == 1:  # Sub: running sum along the row, per byte lane
            cur = np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif kind == 2:  # Up
            cur = (row + prior) & 255
        elif kind in (3, 4):  # Average / Paeth: sequential along the row
            cur = row.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prior[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prior[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                cur[x] = (cur[x] + pred) & 255
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prior = cur
    return out


def decode_png(src: Source) -> np.ndarray:
    """Decode a PNG to its native samples: uint8 or uint16, (H, W) for gray
    or (H, W, C) otherwise."""
    buf = _read_bytes(src)
    if not buf.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos + 8 <= len(buf):
        length, ctype = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(
            f"unsupported PNG (colour type {color}, depth {depth}, "
            f"interlace {interlace}): 8/16-bit non-interlaced gray, "
            "gray+alpha, RGB or RGBA only"
        )
    ch, nbytes = _CHANNELS[color], depth // 8
    stride = w * ch * nbytes
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, ch * nbytes)
    img = rows.reshape(h, w, ch, nbytes)
    if nbytes == 2:
        img = img.view(">u2")[..., 0].astype(np.uint16)
    else:
        img = img[..., 0]
    return img[..., 0] if ch == 1 else img


def encode_png(img: np.ndarray) -> bytes:
    """Encode uint8 (H, W), (H, W, 3) or (H, W, 4), or uint16 (H, W), as a
    PNG (Sub filter on every row)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"expected uint8 or uint16, got {img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[-1]
    color = {1: 0, 2: 4, 3: 2, 4: 6}.get(ch)
    if color is None or img.ndim not in (2, 3):
        raise ValueError(f"expected (H, W) or (H, W, 1-4), got {img.shape}")
    if img.dtype == np.uint16 and ch != 1:
        raise ValueError("16-bit PNG is encoded for gray images only")
    h, w = img.shape[:2]
    nbytes = img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))
                                ).view(np.uint8).reshape(h, -1)
    bpp = ch * nbytes
    sub = rows.astype(np.int16)
    sub[:, bpp:] -= rows[:, :-bpp]
    data = np.empty((h, rows.shape[1] + 1), np.uint8)
    data[:, 0] = 1
    data[:, 1:] = sub & 255

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8 * nbytes, color, 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(data.tobytes(), 6))
            + chunk(b"IEND", b""))


def decode_image(src: Source) -> np.ndarray:
    """Decode JPEG/PNG (path or bytes) -> uint8 (H, W, 3) RGB."""
    buf = _read_bytes(src)
    if buf.startswith(PNG_SIGNATURE):
        img = decode_png(buf)
        if img.dtype != np.uint8:
            img = (img >> 8).astype(np.uint8)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] in (2, 4):  # drop alpha, as PIL's convert("RGB")
            img = img[..., :-1]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        return np.ascontiguousarray(img)
    with _pil().open(_io.BytesIO(buf)) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _is_png(dst, format: Optional[str]) -> bool:
    if format is not None:
        return format.upper() == "PNG"
    return str(dst).lower().endswith(".png")


def encode_image(
    img_u8: np.ndarray,
    dst: Optional[Union[str, os.PathLike]] = None,
    format: Optional[str] = None,
    quality: int = 95,
) -> Optional[bytes]:
    """Encode uint8 (H, W, 3) RGB. With ``dst`` writes a file (format from the
    extension); without, returns encoded bytes (``format`` required)."""
    img_u8 = np.asarray(img_u8)
    if img_u8.dtype != np.uint8:
        raise ValueError(f"expected uint8, got {img_u8.dtype}")
    if dst is None and format is None:
        raise ValueError("format required when encoding to bytes")
    if _is_png(dst, format):
        data = encode_png(img_u8)
    else:
        buf = _io.BytesIO()
        _pil().fromarray(img_u8, mode="RGB").save(buf, format=format or (
            os.path.splitext(str(dst))[1][1:].upper().replace("JPG", "JPEG")),
            quality=quality)
        data = buf.getvalue()
    if dst is None:
        return data
    with open(dst, "wb") as f:
        f.write(data)
    return None
