"""BBDMRunner: sampling with a BBDM or LBBDM (port of the test half of
``bbdm_tpu/runners/bbdm.py``).

Weights: seeded random, then for an LBBDM the frozen VQGAN from
``VQGAN.params.ckpt_path`` (a JAX ``.ckpt`` or an LDM torch checkpoint), then
``model.model_load_path`` (a JAX ``.ckpt`` or a reference ``.pth``): its EMA
weights when ``EMA.use_ema`` holds and it has them. Latent statistics come from
that checkpoint under ``normalize_latent``.

``sample_to_eval`` output contract: ``condition/<x_cond_name>.png``,
``ground_truth/<x_name>.png`` and ``<sample_step>/<x_name>.png``, or
``<sample_step>/<x_name>/output_<j>.png`` when ``testing.sample_num > 1``.
``sample`` writes ``<stage>_sample/{skip_sample,condition,ground_truth}.png``
grids, and with ``testing.sample_mid_step`` the ``reverse_sample/`` and
``reverse_one_step_samples/`` trajectories.
"""

from __future__ import annotations

import os
import zipfile
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bbdm_tpu_torch.checkpoints.from_jax import (
    latent_stats_from_jax,
    load_model_checkpoint,
    state_dict_from_jax,
)
from bbdm_tpu_torch.checkpoints.io import extract_vqgan_tree, load_checkpoint
from bbdm_tpu_torch.models import build_model
from bbdm_tpu_torch.models.latent import LatentBrownianBridgeModel
from bbdm_tpu_torch.runners.base import BaseRunner
from bbdm_tpu_torch.runners.utils import make_dir
from bbdm_tpu_torch.utils.images import get_image_grid, save_single_image, write_png


def _is_torch_file(path: str) -> bool:
    """A ``torch.save`` file (a zip archive, or a ``.pth``/``.pt`` name) rather
    than a msgpack ``.ckpt``."""
    return path.endswith((".pth", ".pt")) or zipfile.is_zipfile(path)


class BBDMRunner(BaseRunner):
    """On ``device`` (default: ``--gpu_ids`` from ``config.args``, else the
    CUDA card; raises where there is none)."""

    def __init__(self, config, *, device=None, seed=None):
        self.latent_stats = None
        super().__init__(config, device=device, seed=seed)

    @property
    def is_latent(self) -> bool:
        return isinstance(self.model, LatentBrownianBridgeModel)

    def initialize_model(self, config, generator):
        model = build_model(config.model, device=self.device, generator=generator)
        if isinstance(model, LatentBrownianBridgeModel):
            self._load_vqgan(model, config.model.VQGAN.params.get("ckpt_path"))
        return model

    def _load_vqgan(self, model, path):
        """The frozen first stage (``bbdm_tpu/runners/bbdm.py:74-98``)."""
        if not path:
            return
        if not os.path.exists(path):
            raise FileNotFoundError(f"VQGAN checkpoint not found: {path}")
        if _is_torch_file(path):
            from bbdm_tpu_torch.checkpoints.torch_import import convert_ldm_vqgan_checkpoint

            tree = convert_ldm_vqgan_checkpoint(path)
        else:
            tree = extract_vqgan_tree(load_checkpoint(path))
        model.vqgan.load_state_dict(state_dict_from_jax(tree, model.vqgan))
        self.logger(f"load vqgan from {path}")

    def _read_states(self, path):
        if _is_torch_file(path):
            from bbdm_tpu_torch.checkpoints.torch_import import convert_reference_checkpoint

            return convert_reference_checkpoint(path, self.config.model)
        return load_checkpoint(path)

    def load_model_from_checkpoint(self):
        """Weights, epoch and step (``bbdm_tpu/runners/base.py:252-268``), and the
        latent statistics (``bbdm_tpu/runners/bbdm.py:102-124``)."""
        model_cfg = self.config.model
        path = model_cfg.get("model_load_path")
        if not path:
            return None
        states = self._read_states(path)
        if not model_cfg.get("only_load_latent_mean_std", False):
            self.logger(f"load model {model_cfg.model_name} from {path}")
            self.global_epoch, self.global_step = load_model_checkpoint(
                states, self.model, self.use_ema)
        if self.is_latent and model_cfg.get("normalize_latent", False) \
                and "ori_latent_mean" in states:
            self.latent_stats = latent_stats_from_jax(states, self.device)
        return states

    # ------------------------------------------------------------ sampling

    def _sample(self, x_cond: np.ndarray, **kw):
        cond = torch.from_numpy(np.asarray(x_cond, np.float32)).permute(0, 3, 1, 2)
        if self.is_latent:
            kw["latent_stats"] = self.latent_stats
        return self.model.sample(cond.to(self.device),
                                 clip_denoised=self.config.testing.get("clip_denoised", False),
                                 generator=self.generator, **kw)

    @staticmethod
    def _nhwc(t: torch.Tensor) -> np.ndarray:
        """[..., C, H, W] -> [..., H, W, C] float32 numpy."""
        return t.float().movedim(-3, -1).cpu().numpy()

    def sample_batch(self, x_cond: np.ndarray) -> np.ndarray:
        """NHWC float condition images -> [sample_num, B, H, W, C] float32 samples."""
        n = self.config.testing.sample_num
        out = self._sample(x_cond, num_samples=n)
        return self._nhwc(out if n > 1 else out[None])

    def sample(self, batch, sample_path, stage="train"):
        """4-image grids (``bbdm_tpu/runners/bbdm.py:278-327``)."""
        sample_path = make_dir(os.path.join(sample_path, f"{stage}_sample"))
        to_normal = self.config.data.dataset_config.to_normal
        grid_size = 4
        x, x_cond = np.asarray(batch["x"])[:4], np.asarray(batch["x_cond"])[:4]
        if self.config.testing.get("sample_mid_step", False):
            every = max(len(self.model.coeffs.steps) // 4, 1)
            for name, traj in zip(("reverse_sample", "reverse_one_step_samples"),
                                  self._sample(x_cond, sample_mid_step=True)):
                self.save_images(self._nhwc(traj), make_dir(os.path.join(sample_path, name)),
                                 grid_size, save_interval=every)
        sample = self._nhwc(self._sample(x_cond))
        for name, img in (("skip_sample", sample), ("condition", x_cond), ("ground_truth", x)):
            write_png(os.path.join(sample_path, f"{name}.png"),
                      get_image_grid(img, grid_size, to_normal=to_normal))

    def save_images(self, all_samples, sample_path, grid_size=4, save_interval=100):
        """``image_<i>.png`` every ``save_interval`` steps of a [S, B, H, W, C]
        trajectory and ``image_out.png`` of its end
        (``bbdm_tpu/runners/diffusion_base.py:21-49``, without the GIF)."""
        to_normal = self.config.data.dataset_config.to_normal
        for i in range(0, len(all_samples), save_interval):
            write_png(os.path.join(sample_path, f"image_{i}.png"),
                      get_image_grid(all_samples[i], grid_size, to_normal=to_normal))
        write_png(os.path.join(sample_path, "image_out.png"),
                  get_image_grid(all_samples[-1], grid_size, to_normal=to_normal))

    def sample_to_eval(self, test_loader, sample_path: str) -> None:
        """Sample every batch of ``test_loader`` (an iterable of dicts with NHWC
        ``x``, ``x_cond`` and name lists ``x_name``, ``x_cond_name``, the
        contract of ``data.DataLoader``) into ``sample_path``
        (``bbdm_tpu/runners/bbdm.py:329-384``). The PNGs of a batch are encoded
        on one writer thread while the card samples the next batch; at most
        two batches wait for it."""
        condition_path = make_dir(os.path.join(sample_path, "condition"))
        gt_path = make_dir(os.path.join(sample_path, "ground_truth"))
        result_path = make_dir(os.path.join(sample_path,
                                            str(self.config.model.BB.params.sample_step)))
        to_normal = self.config.data.dataset_config.to_normal
        sample_num = self.config.testing.sample_num

        def write(samples, x, x_cond, x_names, cond_names):
            for i in range(x.shape[0]):
                save_single_image(x_cond[i], condition_path, f"{cond_names[i]}.png",
                                  to_normal=to_normal)
                save_single_image(x[i], gt_path, f"{x_names[i]}.png", to_normal=to_normal)
                if sample_num > 1:
                    result_path_i = make_dir(os.path.join(result_path, x_names[i]))
                    for j in range(sample_num):
                        save_single_image(samples[j, i], result_path_i, f"output_{j}.png",
                                          to_normal=to_normal)
                else:
                    save_single_image(samples[0, i], result_path, f"{x_names[i]}.png",
                                      to_normal=to_normal)

        pending: deque = deque()
        with ThreadPoolExecutor(1, thread_name_prefix="bbdm-png") as writer:
            try:
                for batch in test_loader:
                    samples = self.sample_batch(batch["x_cond"])
                    while len(pending) >= 2:
                        pending.popleft().result()
                    pending.append(writer.submit(
                        write, samples, np.asarray(batch["x"]), np.asarray(batch["x_cond"]),
                        list(batch["x_name"]), list(batch["x_cond_name"])))
                while pending:
                    pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()
