"""Weights-free paired metrics: PSNR / SSIM / MSE over two image directories
(port of ``bbdm_tpu/evaluation/pixel_metrics.py``). PNG only (the port's reader).
"""

from __future__ import annotations

import os

import numpy as np

from bbdm_tpu_torch.utils.images import read_image


def _load(path):
    return read_image(path).astype(np.float64)


def _ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Global-statistics SSIM (single-window; adequate for smoke tracking)."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = a.mean(), b.mean()
    var_a, var_b = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(
        ((2 * mu_a * mu_b + c1) * (2 * cov + c2))
        / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    )


def calc_psnr_ssim(data_dir: str, gt_dir: str) -> dict:
    """Match files by name between two flat directories."""
    names = sorted(set(os.listdir(data_dir)) & set(os.listdir(gt_dir)))
    if not names:
        raise ValueError(f"no common files between {data_dir} and {gt_dir}")
    psnr_sum = ssim_sum = mse_sum = 0.0
    for name in names:
        a = _load(os.path.join(data_dir, name))
        b = _load(os.path.join(gt_dir, name))
        mse = float(((a - b) ** 2).mean())
        mse_sum += mse
        psnr_sum += 10 * np.log10(255.0**2 / max(mse, 1e-10))
        ssim_sum += _ssim(a, b)
    n = len(names)
    out = {"psnr": psnr_sum / n, "ssim": ssim_sum / n, "mse": mse_sum / n, "count": n}
    print(f"PSNR: {out['psnr']:.3f}  SSIM: {out['ssim']:.4f}  MSE: {out['mse']:.2f}  (n={n})")
    return out
