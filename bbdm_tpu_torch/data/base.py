"""Path-list image dataset (port of ``bbdm_tpu/data/base.py``).

:func:`load_image` reads an image file (``utils/images.py:read_image``: PNG,
JPEG or BMP, as Pillow's ``convert("RGB")`` reads it), resizes it as Pillow's
``Image.resize(..., BILINEAR)`` does, optionally flips it, and returns float32
HWC in [0, 1] or, with ``to_normal``, [-1, 1]. After the decode, the host
library (``native/fastimage.cpp:preprocess_image``) does all of that in one C
call; :func:`load_image_plain` is the numpy version of the same steps for
8-bit PNGs, which the tests hold it against bit for bit. With ``flip`` the dataset doubles: indices past the
original length return the mirrored image.

``cache=True`` (``dataset_config.cache_in_ram``) keeps each finished array in
a process-wide cache (:func:`cache_image`), read-only, so that later epochs
decode nothing.
"""

from __future__ import annotations

import math
import os
import threading
from pathlib import Path

import numpy as np

from bbdm_tpu_torch.native import fastimage
from bbdm_tpu_torch.utils.images import read_image, read_png, to_rgb

_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit images (Resample.c)


def _resample_coeffs(in_size: int, out_size: int):
    """Pillow's triangle-filter table for one axis (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``): the support widens by the scale when
    downscaling. Returns (input index [out, k], fixed-point weight [out, k])."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the bilinear filter's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    k = np.arange(ksize)
    w = np.maximum(1.0 - np.abs((xmin[:, None] + k - center[:, None] + 0.5) / filterscale), 0.0)
    w[k >= xmax[:, None]] = 0.0
    total = np.zeros(out_size)
    for j in range(ksize):  # in order, as the C loop sums
        total += w[:, j]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = np.where(w < 0, -0.5 + w * (1 << _PRECISION_BITS),
                     0.5 + w * (1 << _PRECISION_BITS)).astype(np.int64)  # C (int): to zero
    return np.minimum(xmin[:, None] + k, in_size - 1), fixed


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    idx, fixed = _resample_coeffs(img.shape[axis], out_size)
    taps = np.take(img, idx, axis=axis).astype(np.int64)  # [..., out, k, ...]
    shape = [1] * taps.ndim
    shape[axis], shape[axis + 1] = fixed.shape
    acc = (taps * fixed.reshape(shape)).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] -> [h, w, C] as Pillow's ``resize((w, h), BILINEAR)``:
    a horizontal pass, then a vertical pass, each in 22-bit fixed point and
    rounded to uint8; an axis whose size does not change is not resampled."""
    h, w = size
    if img.shape[1] != w:
        img = _resample_axis(img, w, 1)
    if img.shape[0] != h:
        img = _resample_axis(img, h, 0)
    return img


def load_image_plain(path: str, image_size: tuple[int, int], flip: bool,
                     to_normal: bool) -> np.ndarray:
    """The plain version of :func:`load_image` for 8-bit PNGs, in numpy: PNG
    -> RGB -> resize to (H, W) -> [optional flip] -> float32 HWC."""
    img = resize_bilinear(to_rgb(read_png(path)), tuple(image_size))
    if flip:
        img = img[:, ::-1]
    arr = img.astype(np.float32) / 255.0
    if to_normal:
        arr = np.clip(arr * 2.0 - 1.0, -1.0, 1.0)
    return arr


def _load_image(path: str, image_size: tuple[int, int], flip: bool,
                to_normal: bool) -> np.ndarray:
    return fastimage.preprocess_image(read_image(path), tuple(image_size), flip, to_normal)


def load_image(path: str, image_size: tuple[int, int], flip: bool, to_normal: bool,
               cache: bool = False) -> np.ndarray:
    """Image file -> RGB -> resize to (H, W) -> [optional flip] -> float32 HWC;
    with ``cache`` through :func:`cache_image` (a read-only array)."""
    if cache:
        return cache_image((path, tuple(image_size), flip, to_normal),
                           lambda: _load_image(path, image_size, flip, to_normal))
    return _load_image(path, image_size, flip, to_normal)


# ------------------------------------------------------------ cache_in_ram

def _default_cap_mb() -> float:
    """25% of MemAvailable, at least 4096 MB (``bbdm_tpu/data/base.py:33-44``)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return max(4096.0, 0.25 * int(line.split()[1]) / 1024.0)
    except OSError:
        pass
    return 4096.0


class ImageCache:
    """Decoded images by key, each stored read-only, with a size cap: past it
    an insert raises, naming ``dataset_config.cache_in_ram`` and
    ``BBDM_CACHE_CAP_MB``. The producer of a missing entry runs outside the
    lock (loader threads decode in parallel; two may decode the same key, and
    the first insert wins), the insert under it, so the byte count holds only
    entries that landed."""

    def __init__(self, cap_bytes: int | None = None):
        self._cap = cap_bytes
        self._lock = threading.Lock()
        self._items: dict = {}
        self.nbytes = 0

    def __len__(self):
        return len(self._items)

    def cap_bytes(self) -> int:
        if self._cap is None:
            self._cap = int(float(os.environ.get("BBDM_CACHE_CAP_MB") or _default_cap_mb())
                            * 2 ** 20)
        return self._cap

    def get(self, key, producer) -> np.ndarray:
        hit = self._items.get(key)
        if hit is not None:
            return hit
        arr = producer()
        cap = self.cap_bytes()
        with self._lock:
            hit = self._items.get(key)
            if hit is not None:
                return hit
            if self.nbytes + arr.nbytes > cap:
                raise RuntimeError(
                    f"cache_in_ram footprint would exceed {cap / 2 ** 20:.0f} MB after "
                    f"{len(self._items) + 1} images (~{arr.nbytes / 2 ** 20:.2f} MB each): "
                    "disable dataset_config.cache_in_ram for this dataset or raise "
                    "BBDM_CACHE_CAP_MB")
            arr.setflags(write=False)
            self._items[key] = arr
            self.nbytes += arr.nbytes
        return arr

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
            self.nbytes = 0
            self._cap = None  # read BBDM_CACHE_CAP_MB again at the next insert


IMAGE_CACHE = ImageCache()  # the process-wide cache of cache_in_ram


def cache_image(key, producer) -> np.ndarray:
    """``producer()``'s array, made once per key and process, read-only."""
    return IMAGE_CACHE.get(key, producer)


def clear_image_cache() -> None:
    IMAGE_CACHE.clear()


class ImagePathDataset:
    def __init__(self, image_paths, image_size=(256, 256), flip=False, to_normal=False,
                 cache=False):
        self.image_paths = list(image_paths)
        self.image_size = tuple(image_size)
        self._length = len(self.image_paths)
        self.flip = flip
        self.to_normal = to_normal
        self.cache = cache

    def __len__(self):
        return self._length * 2 if self.flip else self._length

    def __getitem__(self, index):
        do_flip = index >= self._length
        if do_flip:
            index -= self._length
        path = self.image_paths[index]
        return (load_image(path, self.image_size, do_flip, self.to_normal, cache=self.cache),
                Path(path).stem)
