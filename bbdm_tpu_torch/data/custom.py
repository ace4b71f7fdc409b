"""The ``custom_single`` and ``custom_aligned`` datasets (port of
``bbdm_tpu/data/custom.py:30-73``). ``__getitem__`` returns ``((x, x_name),
(x_cond, x_cond_name))``: x the target (domain B), x_cond the condition
(domain A), float32 HWC."""

from __future__ import annotations

import os

from bbdm_tpu_torch.data.base import ImagePathDataset
from bbdm_tpu_torch.data.utils import get_image_paths_from_dir


def _images(dataset_config, fdir, stage):
    size = (dataset_config.image_size, dataset_config.image_size)
    flip = dataset_config.flip if stage == "train" else False
    return ImagePathDataset(get_image_paths_from_dir(os.path.join(dataset_config.dataset_path,
                                                                  fdir)),
                            size, flip=flip, to_normal=dataset_config.to_normal)


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


DATASETS = {"custom_single": CustomSingleDataset, "custom_aligned": CustomAlignedDataset}
