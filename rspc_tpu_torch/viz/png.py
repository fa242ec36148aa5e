"""Minimal dependency-free PNG writer (truecolor RGB8)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an ``u8[H,W,3]`` array as a PNG file."""
    rgb = np.asarray(rgb, np.uint8)
    h, w, c = rgb.shape
    assert c == 3, "expected RGB"

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))
    data = zlib.compress(raw, 6)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", data))
        f.write(chunk(b"IEND", b""))
