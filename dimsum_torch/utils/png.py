"""PNG files with the standard library only (`zlib`, `struct`): the
port's sampler writes 8-bit RGB images, and its datasets read 8-bit grey,
grey + alpha, RGB and RGBA ones, where no imaging package is installed (the
card's machine has no PIL)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image: one IDAT, every row unfiltered."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {image.shape}")
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                            0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # grey, RGB, grey + alpha, RGBA


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec 9.2: 0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth) of (h, 1 + stride) rows; Average and Paeth, whose
    bytes hang on their left neighbours, in Python one byte at a time."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        kind, line = rows[r, 0], rows[r, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[r] = cur
        prev = out[r]
    return out


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode a PNG file's bytes: 8-bit grey, grey + alpha, RGB or RGBA
    without interlace, any of the five row filters, each chunk's CRC
    checked.  Returns (H, W, C) uint8 with the file's C channels (1, 2, 3
    or 4); raises, naming `name`, on anything else."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, header = len(_SIGNATURE), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{name}: bit depth {depth}, color type {color}, interlace "
            f"{interlace}; read here: 8-bit grey, grey + alpha, RGB or RGBA "
            "without interlace")
    ch = _CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[:h * (1 + w * ch)].reshape(h, 1 + w * ch)
    return _unfilter(rows, ch).reshape(h, w, ch)


def read_png(path: str) -> np.ndarray:
    """`decode_png` of a file."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)
