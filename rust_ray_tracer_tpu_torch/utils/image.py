"""PNG output in pure numpy + zlib.

Counterpart of ``encode_png`` and ``save_png`` in
``rust_ray_tracer_tpu/utils/image.py``. The reference writes each pixel
at ``(x, height-1-y)`` (the reference's ``src/main.rs:105-109``); here the
renderer produces a top-down [H, W, 3] array and :func:`save_png` applies
the same vertical flip. The image decoders wait for image textures
(ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """Encode an [H, W, 3] uint8 array as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected [H, W, 3] RGB, got shape {rgb.shape}")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    # filter byte 0 per scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1
    ).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def save_png(path: str, rgb: np.ndarray, flip_vertical: bool = True) -> None:
    """Save [H, W, 3] u8. ``flip_vertical=True`` replicates the
    reference's ``put_pixel(x, height-1-y)`` convention (main.rs:108)."""
    img = np.asarray(rgb)
    if flip_vertical:
        img = img[::-1]
    with open(path, "wb") as f:
        f.write(encode_png(img))
