"""Dataset helpers (port of ``bbdm_tpu/data/utils.py``)."""

from __future__ import annotations

import os


def get_image_paths_from_dir(fdir: str) -> list[str]:
    """Every file under ``fdir``, recursively, sorted at each level."""
    out = []
    for name in sorted(os.listdir(fdir)):
        fpath = os.path.join(fdir, name)
        if os.path.isdir(fpath):
            out.extend(get_image_paths_from_dir(fpath))
        else:
            out.append(fpath)
    return out


def get_dataset(data_config):
    """(train, val, test) datasets of ``data_config.dataset_type``."""
    from bbdm_tpu_torch.data.custom import DATASETS

    kind = data_config.dataset_type
    if kind not in DATASETS:
        raise NotImplementedError(
            f"dataset_type {kind!r} is not ported (ported: {sorted(DATASETS)}; the "
            "colorization and inpainting datasets are in ROADMAP.md §1)")
    cls = DATASETS[kind]
    return tuple(cls(data_config.dataset_config, stage=s) for s in ("train", "val", "test"))
