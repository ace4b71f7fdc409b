"""Images without Pillow: float HWC -> uint8 -> PNG through zlib, PNG -> uint8,
and sample grids.

``to_uint8`` has the arithmetic of ``bbdm_tpu/utils/images.py:15-22``
(mul(0.5).add(0.5).clamp(0,1).mul(255).add(0.5).clamp(0,255));
``get_image_grid`` its torchvision ``make_grid`` layout (``:30-45``).

The PNG reader takes 8-bit gray, gray+alpha, RGB and RGBA, not interlaced,
with any of the five row filters. None, Sub and Up rows are undone in numpy;
Average and Paeth rows depend on the pixel to their left, so they are undone
byte by byte in Python (:func:`_unfilter_sequential`), which costs far more
host time per row. Other formats raise.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_uint8(image: np.ndarray, to_normal: bool = True) -> np.ndarray:
    img = np.asarray(image, dtype=np.float32)
    if to_normal:
        img = np.clip(img * 0.5 + 0.5, 0.0, 1.0)
    return np.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type (gray, gray+a, rgb, rgba)
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, C] (C in 1..4) -> PNG bytes (8 bit, no filtering)."""
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    if C not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes 1 to 4 channels, got {C}")
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], axis=1)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def save_single_image(image, save_path: str, file_name: str, to_normal: bool = True):
    """Write one float HWC image as ``save_path/file_name`` (PNG)."""
    os.makedirs(save_path, exist_ok=True)
    write_png(os.path.join(save_path, file_name), to_uint8(image, to_normal))


def get_image_grid(batch: np.ndarray, grid_size: int = 4, to_normal: bool = True,
                   padding: int = 2) -> np.ndarray:
    """[B, H, W, C] floats -> one uint8 [gH, gW, C] grid (torchvision make_grid layout)."""
    batch = np.asarray(batch)
    B, H, W, C = batch.shape
    ncol = min(grid_size, B)
    nrow = (B + ncol - 1) // ncol
    grid = np.zeros((nrow * (H + padding) + padding, ncol * (W + padding) + padding, C),
                    dtype=np.float32)
    for i in range(B):
        r, c = divmod(i, ncol)
        y, x = padding + r * (H + padding), padding + c * (W + padding)
        grid[y:y + H, x:x + W] = batch[i]
    return to_uint8(grid, to_normal)


# ------------------------------------------------------------------ reading

def _unfilter_sequential(ftype: int, raw: bytes, prev: bytes, bpp: int) -> bytes:
    """Average (3) or Paeth (4) row: each byte adds a predictor of its left
    neighbour (already decoded), so the row is walked in order."""
    cur = bytearray(raw)
    if ftype == 3:
        for i in range(bpp):
            cur[i] = (cur[i] + (prev[i] >> 1)) & 0xFF
        for i in range(bpp, len(cur)):
            cur[i] = (cur[i] + ((cur[i - bpp] + prev[i]) >> 1)) & 0xFF
        return bytes(cur)
    for i in range(bpp):  # no left or upper-left pixel: the predictor is the upper one
        cur[i] = (cur[i] + prev[i]) & 0xFF
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], prev[i], prev[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - c - c)
        cur[i] = (cur[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 0xFF
    return bytes(cur)


def _unfilter(data: bytes, H: int, W: int, bpp: int) -> np.ndarray:
    stride = W * bpp
    rows = np.frombuffer(data, np.uint8)
    if rows.size != H * (stride + 1):
        raise ValueError(f"PNG image data holds {rows.size} bytes, expected {H * (stride + 1)}")
    rows = rows.reshape(H, stride + 1)
    ftypes, raw = rows[:, 0], rows[:, 1:]
    out = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(H):
        f = int(ftypes[r])
        if f == 0:
            out[r] = raw[r]
        elif f == 1:  # Sub: a running sum mod 256 over each channel
            out[r] = np.cumsum(raw[r].reshape(W, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:  # Up
            out[r] = raw[r] + prev
        elif f in (3, 4):
            out[r] = np.frombuffer(_unfilter_sequential(f, raw[r].tobytes(), prev.tobytes(),
                                                        bpp), np.uint8)
        else:
            raise ValueError(f"PNG row filter {f}")
        prev = out[r]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C] with C = 1 (gray), 2 (gray+alpha), 3 or 4."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG chunk")
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad length or CRC")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind != b"PLTE" and not kind[0] & 0x20:  # an unknown critical chunk
            raise ValueError(f"PNG chunk {kind.decode('latin-1')!r} is not supported")
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    W, H, depth, color, compression, filt, interlace = header
    if depth != 8 or color not in _CHANNELS or compression or filt or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {color}, interlace "
                         f"{interlace}: only 8-bit gray, gray+alpha, RGB and RGBA, not "
                         "interlaced, are supported")
    C = _CHANNELS[color]
    return _unfilter(zlib.decompress(b"".join(idat)), H, W, C).reshape(H, W, C)


def read_png(path: str) -> np.ndarray:
    """uint8 [H, W, C] of a PNG file; any other format raises (the port reads
    images without Pillow)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data)
    except (ValueError, zlib.error) as e:
        raise ValueError(f"{path}: {e} (the PyTorch port reads 8-bit PNG only; it does "
                         "not use Pillow)") from None


def to_rgb(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] -> [H, W, 3] as Pillow's ``convert('RGB')``: gray is
    repeated, alpha dropped."""
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]
