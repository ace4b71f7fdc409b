"""Inference runner: the test-set ``sample_to_eval`` sweep
(port of ``bbdm_tpu/runners/bbdm.py:329-384``).

Output contract: ``condition/<x_cond_name>.png``, ``ground_truth/<x_name>.png``
and ``<sample_step>/<x_name>.png``, or ``<sample_step>/<x_name>/output_<j>.png``
when ``testing.sample_num > 1``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bbdm_tpu_torch.models import build_model
from bbdm_tpu_torch.models.factory import resolve_device
from bbdm_tpu_torch.utils.images import save_single_image


class BBDMRunner:
    """Holds the model (seeded random weights until a checkpoint is loaded into
    ``runner.model``), the sampling generator and the latent statistics, on
    ``device`` (default: the CUDA card; raises where there is none)."""

    def __init__(self, config, *, device=None, seed: int = 0):
        self.config = config
        self.device = resolve_device(device)
        self.model = build_model(config.model, device=self.device,
                                 generator=torch.Generator(self.device).manual_seed(seed))
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.latent_stats = None

    def sample_batch(self, x_cond: np.ndarray) -> np.ndarray:
        """NHWC float condition images -> [sample_num, B, H, W, C] float32 samples."""
        n = self.config.testing.sample_num
        cond = torch.from_numpy(np.asarray(x_cond, np.float32)).permute(0, 3, 1, 2)
        out = self.model.sample(cond.to(self.device), num_samples=n,
                                clip_denoised=self.config.testing.get("clip_denoised", False),
                                latent_stats=self.latent_stats, generator=self.generator)
        if n == 1:
            out = out[None]
        return out.float().permute(0, 1, 3, 4, 2).cpu().numpy()

    def sample_to_eval(self, test_loader, sample_path: str) -> None:
        """Sample every batch of ``test_loader`` (an iterable of dicts with NHWC
        ``x``, ``x_cond`` and name lists ``x_name``, ``x_cond_name``, the
        contract of ``bbdm_tpu.data.DataLoader``) into ``sample_path``."""
        condition_path = os.path.join(sample_path, "condition")
        gt_path = os.path.join(sample_path, "ground_truth")
        result_path = os.path.join(sample_path, str(self.config.model.BB.params.sample_step))
        for d in (condition_path, gt_path, result_path):
            os.makedirs(d, exist_ok=True)
        to_normal = self.config.data.dataset_config.to_normal
        sample_num = self.config.testing.sample_num

        for batch in test_loader:
            samples = self.sample_batch(batch["x_cond"])
            x, x_cond = np.asarray(batch["x"]), np.asarray(batch["x_cond"])
            for i in range(x.shape[0]):
                save_single_image(x_cond[i], condition_path, f"{batch['x_cond_name'][i]}.png",
                                  to_normal=to_normal)
                save_single_image(x[i], gt_path, f"{batch['x_name'][i]}.png",
                                  to_normal=to_normal)
                if sample_num > 1:
                    result_path_i = os.path.join(result_path, batch["x_name"][i])
                    for j in range(sample_num):
                        save_single_image(samples[j, i], result_path_i, f"output_{j}.png",
                                          to_normal=to_normal)
                else:
                    save_single_image(samples[0, i], result_path, f"{batch['x_name'][i]}.png",
                                      to_normal=to_normal)
