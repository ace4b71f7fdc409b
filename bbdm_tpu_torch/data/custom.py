"""The five dataset types (port of ``bbdm_tpu/data/custom.py``).
``__getitem__`` returns ``((x, x_name), (x_cond, x_cond_name))``: x the
target, x_cond the condition, float32 HWC. Every dataset reads
``dataset_config.cache_in_ram`` (``data/base.py:cache_image``).

* ``custom_single``: one domain, the condition is the target.
* ``custom_aligned``: ``<stage>/B`` the target, ``<stage>/A`` the condition.
* ``custom_colorization_RGB``: the condition is the image's ITU-R 601 luma,
  repeated over 3 channels.
* ``custom_colorization_LAB``: the target is the image as ``cv2.imread``
  reads it (``read_image(..., imread=True)``: EXIF orientation applied) in
  OpenCV's 8-bit LAB (``data/colors.py``), flipped before the resize, in [0, 255] or, with
  ``to_normal``, (v - 127.5) / 127.5; the condition its L channel x 3.
* ``custom_inpainting``: the condition is the image with a 128-180 px box set
  to 0, drawn from ``np.random.RandomState((mask_seed * 1_000_003 + index) %
  2**31)``, ``index`` before the flip-doubling resolves it; the loader's
  ``set_epoch`` sets ``mask_seed`` (:meth:`set_epoch_seed`).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from bbdm_tpu_torch.data.base import ImagePathDataset, cache_image, load_image
from bbdm_tpu_torch.data.colors import resize_linear, rgb_to_lab
from bbdm_tpu_torch.data.utils import get_image_paths_from_dir
from bbdm_tpu_torch.utils.images import read_image


def _cache(dataset_config) -> bool:
    return bool(getattr(dataset_config, "cache_in_ram", False))


def _images(dataset_config, fdir, stage):
    size = (dataset_config.image_size, dataset_config.image_size)
    flip = dataset_config.flip if stage == "train" else False
    return ImagePathDataset(get_image_paths_from_dir(os.path.join(dataset_config.dataset_path,
                                                                  fdir)),
                            size, flip=flip, to_normal=dataset_config.to_normal,
                            cache=_cache(dataset_config))


class CustomSingleDataset:
    """One domain: the condition is the target."""

    def __init__(self, dataset_config, stage="train"):
        self.imgs = _images(dataset_config, stage, stage)

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        item = self.imgs[i]
        return item, item


class CustomAlignedDataset:
    """Paired translation: ``<stage>/B`` the target, ``<stage>/A`` the condition."""

    def __init__(self, dataset_config, stage="train"):
        self.imgs_ori = _images(dataset_config, f"{stage}/B", stage)
        self.imgs_cond = _images(dataset_config, f"{stage}/A", stage)

    def __len__(self):
        return len(self.imgs_ori)

    def __getitem__(self, i):
        return self.imgs_ori[i], self.imgs_cond[i]


class _FlipDoubledPaths:
    """The images under ``<dataset_path>/<stage>``; with ``flip`` (train only)
    indices past their number are the mirrored images."""

    def __init__(self, dataset_config, stage):
        self.image_size = (dataset_config.image_size, dataset_config.image_size)
        self.image_paths = get_image_paths_from_dir(
            os.path.join(dataset_config.dataset_path, stage))
        self.flip = dataset_config.flip if stage == "train" else False
        self.to_normal = dataset_config.to_normal
        self.cache = _cache(dataset_config)
        self._length = len(self.image_paths)

    def __len__(self):
        return self._length * 2 if self.flip else self._length

    def resolve(self, index):
        """(path, flip) of an index."""
        if index >= self._length:
            return self.image_paths[index - self._length], True
        return self.image_paths[index], False

    def load(self, index):
        path, flip = self.resolve(index)
        return load_image(path, self.image_size, flip, self.to_normal, cache=self.cache), \
            Path(path).stem


class CustomColorizationRGBDataset(_FlipDoubledPaths):
    """Gray -> RGB: the condition is the luma (0.299 R + 0.587 G + 0.114 B) x 3."""

    def __getitem__(self, index):
        img, name = self.load(index)
        lum = img if not self.to_normal else (img + 1.0) / 2.0
        L = lum[..., 0] * 0.299 + lum[..., 1] * 0.587 + lum[..., 2] * 0.114
        cond = np.repeat(L[..., None], 3, axis=-1).astype(np.float32)
        if self.to_normal:
            cond = np.clip(cond * 2.0 - 1.0, -1.0, 1.0)
        return (img, name), (cond, name)


class CustomColorizationLABDataset(_FlipDoubledPaths):
    """LAB colorization: the target is the LAB image, the condition its L x 3."""

    def _decode_lab(self, path, flip):
        lab = rgb_to_lab(read_image(path, imread=True))
        if flip:
            lab = lab[:, ::-1]
        image = resize_linear(lab, self.image_size).astype(np.float32)
        if self.to_normal:
            image = np.clip((image - 127.5) / 127.5, -1.0, 1.0)
        return image

    def __getitem__(self, index):
        path, flip = self.resolve(index)
        if self.cache:  # a key of its own: LAB arrays are not load_image's RGB arrays
            image = cache_image(("lab", path, tuple(self.image_size), flip, self.to_normal),
                                lambda: self._decode_lab(path, flip))
        else:
            image = self._decode_lab(path, flip)
        cond = np.repeat(image[..., 0:1], 3, axis=-1)
        name = Path(path).stem
        return (image, name), (cond, name)


class CustomInpaintingDataset(_FlipDoubledPaths):
    """Inpainting: the condition is the image with a 128-180 px box set to 0."""

    def __init__(self, dataset_config, stage="train"):
        super().__init__(dataset_config, stage)
        self.mask_seed = 0

    def set_epoch_seed(self, seed: int):
        """Draw other boxes for another epoch (the loader's ``set_epoch``)."""
        self.mask_seed = int(seed)

    def box(self, index):
        """(top, left, height, width) of the box at ``index``."""
        h, w = self.image_size
        rng = np.random.RandomState((self.mask_seed * 1_000_003 + index) % (2 ** 31))
        mask_w = rng.randint(128, 181)
        mask_h = rng.randint(128, 181)
        return rng.randint(0, h - mask_h + 1), rng.randint(0, w - mask_w + 1), mask_h, mask_w

    def __getitem__(self, index):
        img, name = self.load(index)
        top, left, mh, mw = self.box(index)
        cond = img.copy()
        cond[top:top + mh, left:left + mw, :] *= 0.0  # img * mask, bit for bit (-0.0 kept)
        return (img, name), (cond, name)


DATASETS = {"custom_single": CustomSingleDataset, "custom_aligned": CustomAlignedDataset,
            "custom_colorization_RGB": CustomColorizationRGBDataset,
            "custom_colorization_LAB": CustomColorizationLABDataset,
            "custom_inpainting": CustomInpaintingDataset}
