"""Path-list image dataset (port of ``bbdm_tpu/data/base.py:85-150``).

:func:`load_image` decodes a PNG (``utils/images.py``), converts it to RGB,
resizes it with :func:`resize_bilinear` (Pillow's ``Image.resize(...,
BILINEAR)``), optionally flips it, and returns float32 HWC in [0, 1] or, with
``to_normal``, [-1, 1]. With ``flip`` the dataset doubles: indices past the
original length return the mirrored image.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from bbdm_tpu_torch.utils.images import read_png, to_rgb

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


def load_image(path: str, image_size: tuple[int, int], flip: bool, to_normal: bool) -> np.ndarray:
    """PNG -> RGB -> resize to (H, W) -> [optional flip] -> float32 HWC."""
    img = resize_bilinear(to_rgb(read_png(path)), tuple(image_size))
    if flip:
        img = img[:, ::-1]
    arr = img.astype(np.float32) / 255.0
    if to_normal:
        arr = np.clip(arr * 2.0 - 1.0, -1.0, 1.0)
    return arr


class ImagePathDataset:
    def __init__(self, image_paths, image_size=(256, 256), flip=False, to_normal=False):
        self.image_paths = list(image_paths)
        self.image_size = tuple(image_size)
        self._length = len(self.image_paths)
        self.flip = flip
        self.to_normal = to_normal

    def __len__(self):
        return self._length * 2 if self.flip else self._length

    def __getitem__(self, index):
        do_flip = index >= self._length
        if do_flip:
            index -= self._length
        path = self.image_paths[index]
        return load_image(path, self.image_size, do_flip, self.to_normal), Path(path).stem
