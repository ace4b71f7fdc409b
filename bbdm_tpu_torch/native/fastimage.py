"""numpy wrappers over the host image library (``fastimage.cpp``, ``jpeg.cpp``,
``webp.cpp``).

Each checks shapes and dtypes, hands contiguous buffers to one C entry (ctypes
releases the GIL for the call, so loader threads decode in parallel) and
raises ``ValueError`` where the C entry refuses its input. The library is built
on the first call (:func:`bbdm_tpu_torch.native.build.library`).
"""

from __future__ import annotations

import ctypes

import numpy as np

from bbdm_tpu_torch.native.build import library


def _u8(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or not 1 <= img.shape[2] <= 4 or min(img.shape) < 1:
        raise ValueError(f"expected uint8 [H, W, 1..4], got {img.shape}")
    return img


def unfilter(data: bytes, rows: int, stride: int, bpp: int) -> np.ndarray:
    """PNG rows (a filter byte, then ``stride`` bytes, each) -> uint8 [rows, stride]."""
    out = np.empty((rows, stride), np.uint8)
    code = library().png_unfilter(data, len(data), rows, stride, bpp, out.ctypes.data)
    if code < 0:
        raise ValueError(f"PNG image data holds {len(data)} bytes, expected "
                         f"{rows * (stride + 1)}")
    if code > 0:
        raise ValueError(f"PNG row {code - 1}: filter type "
                         f"{data[(code - 1) * (stride + 1)]}")
    return out


def preprocess_image(img: np.ndarray, size: tuple[int, int], flip: bool,
                     to_normal: bool) -> np.ndarray:
    """uint8 [H, W, C] -> float32 [h, w, 3]: RGB, resized, optionally flipped,
    in [0, 1] or (``to_normal``) [-1, 1]."""
    img = _u8(img)
    h, w = size
    out = np.empty((h, w, 3), np.float32)
    if library().preprocess_image(img.ctypes.data, *img.shape, out.ctypes.data, h, w,
                                  int(flip), int(to_normal)):
        raise ValueError(f"preprocess_image: bad size {size}")
    return out


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3], as libjpeg-turbo decodes them by default."""
    lib = library()
    err = ctypes.create_string_buffer(256)
    info = (ctypes.c_int * 3)()
    if lib.jpeg_info(data, len(data), info, err, len(err)):
        raise ValueError(err.value.decode())
    out = np.empty((info[0], info[1], 3), np.uint8)
    if lib.jpeg_decode(data, len(data), out.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode())
    return out


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> uint8 [H, W, 3], as libwebp decodes them by default: the RGB
    of a still image, or of an animation's first frame on its canvas."""
    lib = library()
    err = ctypes.create_string_buffer(256)
    info = (ctypes.c_int * 2)()
    if lib.webp_info(data, len(data), info, err, len(err)):
        raise ValueError(err.value.decode())
    out = np.empty((info[0], info[1], 3), np.uint8)
    if lib.webp_decode(data, len(data), out.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode())
    return out


def gif_lzw(indices: np.ndarray) -> bytes:
    """The GIF LZW code stream (minimum code size 8) of uint8 palette indices."""
    idx = np.ascontiguousarray(indices, np.uint8).reshape(-1)
    out = np.empty(2 * idx.size + 64, np.uint8)  # 12-bit codes: at most 1.5 bytes an index
    n = library().gif_lzw(idx.ctypes.data, idx.size, out.ctypes.data, out.size)
    if n < 0:
        raise ValueError("gif_lzw: output buffer too small")
    return out[:n].tobytes()
