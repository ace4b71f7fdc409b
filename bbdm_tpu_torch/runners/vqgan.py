"""VQGANRunner: first-stage (VQGAN) training and reconstruction (port of
``bbdm_tpu/runners/vqgan.py``).

Config (``configs/Template-VQGAN-f4.yaml``): ``model_type: VQGAN``, the
autoencoder under ``model.VQGAN.params``, the adversarial loss and the
discriminator's geometry under ``model.loss``, Adam's ``lr`` and ``beta1``
under ``model.optimizer``. Both players train with Adam at that lr, the
generator with betas (beta1, 0.9), the discriminator with (0.5, 0.9); no
plateau schedule and no EMA (``training/gan.py`` has the step). With
``model.loss.lpips_weights`` the reconstruction term adds LPIPS-VGG
(``evaluation/lpips.py``), as the JAX runner does.

Checkpoints use the JAX runner's layout: the model file ``{"model":
{"vqgan", "discriminator", "disc_stats"}, "step", "epoch"}``, the optimizer
file ``{"optimizer": [gen_opt, disc_opt], "scheduler": []}``, so either
package resumes the other's run, and the model file loads as an LBBDM's first
stage (``VQGAN.params.ckpt_path``). ``model_load_path`` also takes a full
taming/LDM training ``.pth`` (``checkpoints/torch_import.py``).

The eval step, ``sample`` and ``sample_to_eval`` run the autoencoder in eval
mode (its up-convs are kernel K2 on the card), ``sample`` writing
``<stage>_sample/{input,reconstruction}.png`` grids and ``sample_to_eval``
``reconstruction/`` and ``ground_truth/`` PNGs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bbdm_tpu_torch.checkpoints.from_jax import (
    adam_state_from_jax,
    adam_state_to_jax,
    jax_tree_from_state_dict,
    load_module_trees,
    module_trees_to_jax,
)
from bbdm_tpu_torch.checkpoints.io import load_checkpoint
from bbdm_tpu_torch.config import dict2namespace
from bbdm_tpu_torch.models import build_model
from bbdm_tpu_torch.models.layers import eval_mode
from bbdm_tpu_torch.parallel import collectives
from bbdm_tpu_torch.runners.base import BaseRunner
from bbdm_tpu_torch.runners.utils import is_torch_file, make_dir
from bbdm_tpu_torch.training.gan import GANTrainState, make_vqgan_train_step
from bbdm_tpu_torch.training.optim import Optimizer
from bbdm_tpu_torch.utils.images import get_image_grid, save_single_image, write_png


def _adam(params, lr, beta1):
    """Adam with b2 0.9, as the JAX runner builds both players' optimizers."""
    return Optimizer(dict2namespace({"optimizer": "Adam", "lr": lr, "beta1": beta1}),
                     params, b2=0.9)


class VQGANRunner(BaseRunner):
    """On ``device`` (default: ``--gpu_ids`` from ``config.args``, else the
    CUDA card; raises where there is none)."""

    def initialize_model(self, config, generator):
        model = build_model(config.model, device=self.device, generator=generator)
        count = lambda m: sum(p.numel() for p in m.parameters()) / 1e6
        self.logger("VQGAN parameters: %.2fM  discriminator: %.2fM"
                    % (count(model.vqgan), count(model.discriminator)))
        return model

    def initialize_optimizer_scheduler(self, params, config):
        """The generator's Adam over ``params``, no plateau config, the lr."""
        opt = config.model.optimizer
        return _adam(params, opt.lr, opt.get("beta1", 0.5)), None, opt.lr

    def build_initial_state(self) -> GANTrainState:
        gen = dict(self.model.vqgan.named_parameters())
        disc = dict(self.model.discriminator.named_parameters())
        gen_opt, self.lr_scheduler_config, lr = self.initialize_optimizer_scheduler(
            gen, self.config)
        return GANTrainState(step=self.global_step, gen_params=gen, disc_params=disc,
                             gen_opt=gen_opt, disc_opt=_adam(disc, lr, 0.5),
                             lr=torch.tensor(lr, dtype=torch.float32, device=self.device))

    def build_train_step(self):
        """The GAN step; with ``model.loss.lpips_weights`` the perceptual term runs
        LPIPS-VGG with those weights on the runner's device (frozen: in no
        optimizer, checkpoint or EMA)."""
        loss_cfg = self.config.model.loss
        lpips = None
        lp = loss_cfg.get("lpips_weights", None)
        if lp:
            from bbdm_tpu_torch.evaluation.lpips import load_lpips

            lpips = load_lpips(lp, net="vgg", device=self.device)
            self.logger(f"perceptual loss enabled (LPIPS weights: {lp})")
        elif loss_cfg.get("perceptual_weight", 1.0) > 0:
            self.logger("no lpips_weights configured: training with pixel L1 only")
        step = make_vqgan_train_step(self.model.vqgan, self.model.discriminator, loss_cfg,
                                     lpips=lpips,
                                     debug_nan=bool(self.config.training.get("debug_nan",
                                                                             False)))
        return lambda state, x, y, generator=None: step(state, x, generator)

    def build_eval_step(self):
        """Reconstruction L1 with the autoencoder in eval mode, the mean over ranks."""
        vq = self.model.vqgan

        def eval_step(state, x, y, generator=None):
            with eval_mode(vq), torch.no_grad():
                xrec, _ = vq(x)
                return collectives.mean((x - xrec).abs().mean())

        return eval_step

    def _put_batch(self, batch):
        x = self._to_device(batch["x"])  # the condition is the image itself
        return x, x

    # ---------------------------------------------------------- checkpoints

    def get_checkpoint_states(self, stage="epoch_end"):
        disc, stats = module_trees_to_jax(self.model.discriminator)
        model_states = {
            "step": int(self.state.step),
            "model": {"vqgan": jax_tree_from_state_dict(self.model.vqgan),
                      "discriminator": disc, "disc_stats": stats},
            "epoch": self.global_epoch + 1 if stage == "epoch_end" else self.global_epoch,
        }
        optim_states = {"optimizer": [adam_state_to_jax(self.state.gen_opt),
                                      adam_state_to_jax(self.state.disc_opt)],
                        "scheduler": []}
        return model_states, optim_states

    def load_model_from_checkpoint(self):
        """Weights, counters and, when training, both Adam states
        (``bbdm_tpu/runners/vqgan.py:170-213``); a checkpoint converted with
        another discriminator geometry is refused by name."""
        model_cfg = self.config.model
        path = model_cfg.get("model_load_path")
        if not path:
            return None
        self.logger(f"load model {model_cfg.model_name} from {path}")
        if is_torch_file(path):
            from bbdm_tpu_torch.checkpoints.torch_import import convert_vqgan_train_checkpoint

            states, _ = convert_vqgan_train_checkpoint(path)
        else:
            states = load_checkpoint(path)
        if "disc_config" in states:
            loss_cfg = model_cfg.loss
            want = {"disc_num_layers": loss_cfg.get("disc_num_layers", 3),
                    "use_actnorm": bool(loss_cfg.get("use_actnorm", False)),
                    "disc_ndf": loss_cfg.get("disc_ndf", 64)}
            got = {k: type(want[k])(states["disc_config"][k]) for k in want}
            if got != want:
                raise ValueError(
                    f"checkpoint {path} was converted with discriminator geometry {got}, but "
                    f"model.loss configures {want}: align disc_num_layers/use_actnorm/"
                    "disc_ndf in the config with the checkpoint")
        self.global_epoch, self.global_step = int(states["epoch"]), int(states["step"])
        trees = states["model"]
        load_module_trees(self.model.vqgan, trees["vqgan"])
        load_module_trees(self.model.discriminator, trees["discriminator"],
                          trees.get("disc_stats"))
        if self.state is not None:
            self.state.step = self.global_step
            opt_path = model_cfg.get("optim_sche_load_path")
            if opt_path:
                self.logger(f"load optimizer from {opt_path}")
                osd = load_checkpoint(opt_path)
                adam_state_from_jax(osd["optimizer"][0], self.state.gen_opt)
                adam_state_from_jax(osd["optimizer"][1], self.state.disc_opt)
        return states

    # ------------------------------------------------------------- sampling

    def reconstruct(self, x: np.ndarray) -> np.ndarray:
        """NHWC float images -> NHWC float32 reconstructions (eval mode)."""
        xrec = self.model.vqgan.roundtrip(self._to_device(x))
        return xrec.float().permute(0, 2, 3, 1).cpu().numpy()

    def sample(self, batch, sample_path, stage="train"):
        """Input / reconstruction grids of the first 4 images."""
        sample_path = make_dir(os.path.join(sample_path, f"{stage}_sample"))
        to_normal = self.config.data.dataset_config.to_normal
        x = np.asarray(batch["x"])[:4]
        for name, img in (("input", x), ("reconstruction", self.reconstruct(x))):
            grid = get_image_grid(img, 4, to_normal=to_normal)
            write_png(os.path.join(sample_path, f"{name}.png"), grid)
            if stage != "test" and self.writer is not None:
                self.writer.add_image(f"{stage}_{name}", grid, self.global_step)

    def sample_to_eval(self, test_loader, sample_path):
        """Reconstruct the test set (for rFID and reconstruction metrics); data
        parallel, each rank its rows of each batch, model index 0 writing
        those of its model group."""
        rec_path, gt_path = self.shared_dirs(os.path.join(sample_path, "reconstruction"),
                                             os.path.join(sample_path, "ground_truth"))
        to_normal = self.config.data.dataset_config.to_normal
        for batch in test_loader:
            x = np.asarray(batch["x"])
            xrec = self.reconstruct(x)
            if self.grid.model_index:
                continue
            for i, name in enumerate(batch["x_name"]):
                save_single_image(x[i], gt_path, f"{name}.png", to_normal=to_normal)
                save_single_image(xrec[i], rec_path, f"{name}.png", to_normal=to_normal)
