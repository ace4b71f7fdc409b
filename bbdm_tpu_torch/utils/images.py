"""Image save helpers without Pillow: float HWC -> uint8 -> PNG through zlib.

``to_uint8`` has the arithmetic of ``bbdm_tpu/utils/images.py:15-22``
(mul(0.5).add(0.5).clamp(0,1).mul(255).add(0.5).clamp(0,255)).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def to_uint8(image: np.ndarray, to_normal: bool = True) -> np.ndarray:
    img = np.asarray(image, dtype=np.float32)
    if to_normal:
        img = np.clip(img * 0.5 + 0.5, 0.0, 1.0)
    return np.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type (gray, gray+a, rgb, rgba)


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, C] (C in 1..4) -> PNG bytes (8 bit, no filtering)."""
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    if C not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes 1 to 4 channels, got {C}")

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_single_image(image, save_path: str, file_name: str, to_normal: bool = True):
    """Write one float HWC image as ``save_path/file_name`` (PNG)."""
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, file_name), "wb") as f:
        f.write(encode_png(to_uint8(image, to_normal)))
