"""Sample diversity: mean per-pixel std over the N outputs per input (port of
``bbdm_tpu/evaluation/diversity.py``, reference `evaluation/diversity.py:8-39`).

Directory protocol: <data_dir>/<i>/output_<j>.png for i in 0..total-1
(after ``rename_samples``), j in 0..num_samples-1. PNG only (the port's reader).
"""

from __future__ import annotations

import os

import numpy as np

from bbdm_tpu_torch.utils.images import read_png, to_rgb


def _load_255(path: str) -> np.ndarray:
    return to_rgb(read_png(path)).astype(np.float64)  # [0,255]


def calc_diversity(data_dir: str, num_samples: int = 5, use_names: bool = False) -> float:
    """Mean over inputs of mean per-pixel std across the num_samples outputs.

    use_names=False follows the reference exactly (subdirs named 0..total-1);
    use_names=True iterates the actual subdir names (works directly on a
    sample_to_eval tree without the rename step).
    """
    dir_list = sorted(os.listdir(data_dir))
    total = len(dir_list)
    std_sum = 0.0
    for i in range(total):
        sub = dir_list[i] if use_names else str(i)
        imgs = np.stack([
            _load_255(os.path.join(data_dir, sub, f"output_{j}.png"))
            for j in range(num_samples)
        ])
        std_sum += float(np.std(imgs, axis=0).mean())
    diversity = std_sum / total
    print(data_dir)
    print(f"diversity: {diversity}")
    return diversity
