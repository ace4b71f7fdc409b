"""BBDMRunner: training and sampling with a BBDM or LBBDM (port of
``bbdm_tpu/runners/bbdm.py``).

Weights: seeded random, then for an LBBDM the frozen VQGAN from
``VQGAN.params.ckpt_path`` (a JAX ``.ckpt`` or an LDM torch checkpoint), then
``model.model_load_path`` (a JAX ``.ckpt`` or a reference ``.pth``). For
sampling the model takes its EMA weights when ``EMA.use_ema`` holds and it
has them; for training it takes the ``model`` tree and the EMA state the
``ema`` tree, and ``model.optim_sche_load_path`` gives the optimizer and
plateau states. Latent statistics come from that checkpoint under
``normalize_latent``, or, when training without them, from the two-pass
dataset mean and std of :meth:`BBDMRunner.get_latent_mean_std`.

The optimizer is ``model.BB.optimizer`` over the UNet (and the cond stage)
with ``model.BB.lr_scheduler`` as the plateau schedule; the VQGAN is frozen.

``sample_to_eval`` output contract: ``condition/<x_cond_name>.png``,
``ground_truth/<x_name>.png`` and ``<sample_step>/<x_name>.png``, or
``<sample_step>/<x_name>/output_<j>.png`` when ``testing.sample_num > 1``.
``sample`` writes ``<stage>_sample/{skip_sample,condition,ground_truth}.png``
grids, and with ``testing.sample_mid_step`` the ``reverse_sample/`` and
``reverse_one_step_samples/`` trajectories.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bbdm_tpu_torch.checkpoints.from_jax import (
    LATENT_STATS,
    latent_stats_from_jax,
    latent_stats_to_jax,
    load_model_checkpoint,
    opt_state_from_jax,
    plateau_from_jax,
    state_dict_from_jax,
)
from bbdm_tpu_torch.checkpoints.io import extract_vqgan_tree, load_checkpoint
from bbdm_tpu_torch.models import build_model
from bbdm_tpu_torch.models.latent import LatentBrownianBridgeModel, init_latent_stats
from bbdm_tpu_torch.parallel import collectives
from bbdm_tpu_torch.runners.base import BaseRunner
from bbdm_tpu_torch.runners.utils import is_torch_file, make_dir
from bbdm_tpu_torch.training.optim import Optimizer
from bbdm_tpu_torch.utils.gif import write_gif
from bbdm_tpu_torch.utils.images import get_image_grid, save_single_image, write_png
from bbdm_tpu_torch.utils.spans import span


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
        if is_torch_file(path):
            from bbdm_tpu_torch.checkpoints.torch_import import convert_ldm_vqgan_checkpoint

            tree = convert_ldm_vqgan_checkpoint(path)
        else:
            tree = extract_vqgan_tree(load_checkpoint(path))
        model.vqgan.load_state_dict(state_dict_from_jax(tree, model.vqgan))
        self.logger(f"load vqgan from {path}")

    def _read_states(self, path):
        if is_torch_file(path):
            from bbdm_tpu_torch.checkpoints.torch_import import convert_reference_checkpoint

            return convert_reference_checkpoint(path, self.config.model)
        return load_checkpoint(path)

    def initialize_optimizer_scheduler(self, params, config):
        """``bbdm_tpu/runners/bbdm.py:61-72``: the optimizer over the trainable
        parameters, the plateau config and the initial lr."""
        optim_cfg = config.model.BB.optimizer
        if self.fuse_threshold() is not None:
            self.logger(f"training.fuse_small_leaves: the optimizer state's checkpoint layout "
                        f"buckets the trainable leaves of <= {self.fuse_threshold()} elements "
                        "as the JAX runner does; the update is per-leaf torch._foreach_*")
        return Optimizer(optim_cfg, params), config.model.BB.lr_scheduler, optim_cfg.lr

    def fuse_threshold(self):
        """``training.fuse_threshold`` (default 65536) under
        ``training.fuse_small_leaves`` (``bbdm_tpu/runners/bbdm.py:64-70``)."""
        training = self.config.get("training") or {}
        if not training.get("fuse_small_leaves", False):
            return None
        return int(training.get("fuse_threshold", 65536))

    def load_model_from_checkpoint(self):
        """Weights, epoch and step (``bbdm_tpu/runners/base.py:252-293``), the
        optimizer and plateau states when training, and the latent statistics
        (``bbdm_tpu/runners/bbdm.py:102-124``)."""
        model_cfg = self.config.model
        path = model_cfg.get("model_load_path")
        states = self._read_states(path) if path else None
        if states is not None and not model_cfg.get("only_load_latent_mean_std", False):
            self.logger(f"load model {model_cfg.model_name} from {path}")
            if self.state is None:
                self.global_epoch, self.global_step = load_model_checkpoint(
                    states, self.model, self.use_ema)
            else:
                self._resume(states, model_cfg.get("optim_sche_load_path"))
        if self.is_latent and model_cfg.get("normalize_latent", False):
            if states is not None and "ori_latent_mean" in states:
                self.latent_stats = latent_stats_from_jax(states, self.device)
            elif self.state is not None:
                self.get_latent_mean_std()
        if self.state is not None:
            self.state.latent_stats = self.latent_stats
        return states

    def _resume(self, states, optim_path):
        """Training resume: the ``model`` tree into the model, the ``ema`` tree
        into the EMA state (the ``model`` tree where the file has none), the
        counters, and the optimizer and plateau from ``optim_path``."""
        self.global_epoch, self.global_step = load_model_checkpoint(states, self.model, False)
        self.state.step = self.global_step
        if self.use_ema:
            ema = state_dict_from_jax(states.get("ema", states["model"]), self.model)
            with torch.no_grad():
                for k, t in self.state.ema.items():
                    t.copy_(ema[k])
        if optim_path:
            self.logger(f"load optimizer and scheduler from {optim_path}")
            osd = load_checkpoint(optim_path)
            opt_state_from_jax(osd["optimizer"][0], self.state.optimizer, self.model,
                               self.fuse_threshold())
            self.state.plateau = plateau_from_jax(osd["scheduler"][0], self.device)

    def get_checkpoint_states(self, stage="epoch_end"):
        """The base states plus the latent statistics under ``normalize_latent``."""
        model_states, optim_states = super().get_checkpoint_states(stage)
        if self.is_latent and self.config.model.get("normalize_latent", False):
            stats = self.latent_stats or init_latent_stats(
                self.model.unet.out_conv.weight.shape[0], self.device)
            model_states.update(latent_stats_to_jax(stats))
        return model_states, optim_states

    @torch.no_grad()
    def get_latent_mean_std(self):
        """The two-pass dataset latent statistics (``bbdm_tpu/runners/bbdm.py:138-217``):
        the mean of per-batch means over the shuffled train set's full batches,
        then the mean of per-batch mean squared deviations from it; std is its
        square root. Data parallel, each rank encodes its rows of each batch and
        the totals are averaged over ranks after each pass (JAX's ``combine``),
        so every rank ends with the same statistics. Under
        ``training.device_data_cache`` the batches are gathered from the train
        set's resident copy, which :meth:`train` then reuses."""
        from bbdm_tpu_torch.data import get_dataset

        loader = self._device_cache("train", self._loader(get_dataset(self.config.data)[0],
                                                          self.config.data.train.batch_size,
                                                          True))
        if len(loader) == 0:
            raise ValueError("latent statistics: the train set has no full batch")

        def latents():
            for batch in loader:
                x, y = self._put_batch(batch)
                yield (self.model.encode(x, cond=False, normalize=False),
                       self.model.encode(y, cond=True, normalize=False))

        def batch_mean(t):
            return t.mean(dim=(0, 2, 3), keepdim=True)

        self.logger("start calculating latent mean")
        tot_o = tot_c = 0.0
        for xl, yl in latents():
            tot_o, tot_c = tot_o + batch_mean(xl), tot_c + batch_mean(yl)
        ori_mean, cond_mean = (collectives.mean(t) / len(loader) for t in (tot_o, tot_c))
        self.logger("start calculating latent std")
        tot_o = tot_c = 0.0
        for xl, yl in latents():
            tot_o = tot_o + batch_mean((xl - ori_mean) ** 2)
            tot_c = tot_c + batch_mean((yl - cond_mean) ** 2)
        ori_std, cond_std = (torch.sqrt(collectives.mean(t) / len(loader))
                             for t in (tot_o, tot_c))
        self.latent_stats = dict(zip(LATENT_STATS, (ori_mean, ori_std, cond_mean, cond_std)))
        for k, v in self.latent_stats.items():
            self.logger(f"{k}: {v.flatten().cpu().numpy()}")

    # ------------------------------------------------------------ sampling

    def _sample(self, x_cond: np.ndarray, **kw):
        if self.is_latent:
            kw["latent_stats"] = self.latent_stats
        return self.model.sample(self._to_device(x_cond),
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
        """4-image grids (``bbdm_tpu/runners/bbdm.py:278-327``), also written to
        TensorBoard outside the test stage."""
        sample_path = make_dir(os.path.join(sample_path, f"{stage}_sample"))
        to_normal = self.config.data.dataset_config.to_normal
        grid_size = 4
        log = stage != "test" and self.writer is not None
        x, x_cond = self._host(batch["x"][:4]), self._host(batch["x_cond"][:4])
        if self.config.testing.get("sample_mid_step", False):
            every = max(len(self.model.coeffs.steps) // 4, 1)
            for name, tag, traj in zip(("reverse_sample", "reverse_one_step_samples"),
                                       (f"{stage}_sample", f"{stage}_one_step_sample"),
                                       self._sample(x_cond, sample_mid_step=True)):
                self.save_images(self._nhwc(traj), make_dir(os.path.join(sample_path, name)),
                                 grid_size, save_interval=every, writer_tag=tag if log else None)
        sample = self._nhwc(self._sample(x_cond))
        for name, img in (("skip_sample", sample), ("condition", x_cond), ("ground_truth", x)):
            grid = get_image_grid(img, grid_size, to_normal=to_normal)
            write_png(os.path.join(sample_path, f"{name}.png"), grid)
            if log:
                self.writer.add_image(f"{stage}_{name}", grid, self.global_step)

    def save_images(self, all_samples, sample_path, grid_size=4, gif_interval=-1,
                    save_interval=100, head_threshold=10000, tail_threshold=0,
                    writer_tag=None):
        """Grids of a [S, B, H, W, C] trajectory
        (``bbdm_tpu/runners/diffusion_base.py:21-49``): ``image_<i>.png`` where
        ``i % save_interval == 0``, ``i > head_threshold`` or ``i <
        tail_threshold``; ``movie.gif`` of every ``gif_interval``-th step when
        ``gif_interval > 0`` (``utils/gif.py``); ``image_out.png`` of the end,
        which also goes to TensorBoard under ``writer_tag``."""
        to_normal = self.config.data.dataset_config.to_normal
        frames = []
        for i in range(len(all_samples)):
            save_png = i % save_interval == 0 or i > head_threshold or i < tail_threshold
            save_gif = gif_interval > 0 and i % gif_interval == 0
            if not (save_png or save_gif):
                continue
            grid = get_image_grid(all_samples[i], grid_size, to_normal=to_normal)
            if save_gif:
                frames.append(grid)
            if save_png:
                write_png(os.path.join(sample_path, f"image_{i}.png"), grid)
        final = get_image_grid(all_samples[-1], grid_size, to_normal=to_normal)
        write_png(os.path.join(sample_path, "image_out.png"), final)
        if writer_tag is not None:
            self.writer.add_image(writer_tag, final, self.global_step)
        if frames:
            write_gif(os.path.join(sample_path, "movie.gif"), frames, duration=1, loop=0)

    def sample_to_eval(self, test_loader, sample_path: str) -> None:
        """Sample every batch of ``test_loader`` (an iterable of dicts with NHWC
        ``x``, ``x_cond`` and name lists ``x_name``, ``x_cond_name``, the
        contract of ``data.DataLoader``) into ``sample_path``
        (``bbdm_tpu/runners/bbdm.py:329-384``). The PNGs of a batch are encoded
        on one writer thread while the card samples the next batch; at most
        two batches wait for it. Data parallel, each rank samples and writes
        its rows of each batch (the loader gives them); the ranks of a model
        group sample the same rows, and model index 0 writes them."""
        condition_path, gt_path, result_path = self.shared_dirs(
            os.path.join(sample_path, "condition"), os.path.join(sample_path, "ground_truth"),
            os.path.join(sample_path, str(self.config.model.BB.params.sample_step)))
        to_normal = self.config.data.dataset_config.to_normal
        sample_num = self.config.testing.sample_num
        writes = self.grid.model_index == 0

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
                    if not writes:
                        continue
                    with span("runner.writer_wait"):
                        while len(pending) >= 2:
                            pending.popleft().result()
                    pending.append(writer.submit(
                        write, samples, np.asarray(batch["x"]), np.asarray(batch["x_cond"]),
                        list(batch["x_name"]), list(batch["x_cond_name"])))
                with span("runner.writer_wait"):
                    while pending:
                        pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()
