"""The rank processes of tests/test_torch_parallel.py (torch and the port only:
no JAX, so that a spawned rank starts quickly).

:func:`run` is a rank of a gloo group on the CPU. It runs every scenario once,
each rank writing what it computed under the work directory; the test calls
the same scenario functions in its own process, outside any group, for the
one-rank runs they are held against.
"""

from __future__ import annotations

import os
import signal
from types import SimpleNamespace

import numpy as np
import torch

from bbdm_tpu_torch import parallel
from bbdm_tpu_torch.config import dict2namespace
from bbdm_tpu_torch.parallel.collectives import local_rows

VQ_STEPS, VQ_BATCH, VQ_SIZE, VQ_LR = 3, 4, 16, 1e-4


def run(rank: int, size: int, port: int, work: str) -> None:
    # one thread per rank: ranks whose OpenMP pools share the cores spin against
    # each other at every collective (ten times slower here)
    torch.set_num_threads(1)
    parallel.initialize(rank, size, init_method=f"tcp://127.0.0.1:{port}", local_size=size,
                        backend="gloo")
    try:
        lbbdm_steps(rank, size, work)
        vqgan_steps(rank, size, work)
        vqgan_runner(rank, size, work)
        sample_to_eval(rank, size, work)
        train_until_stopped(rank, size, work)
        device_cache_rows(rank, size, work)
    finally:
        parallel.shutdown()


def _rows(a, rank, size):
    return a[local_rows(a.shape[0], rank, size)]


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


# ------------------------------------------------------------ LBBDM steps

def lbbdm_steps(rank, size, work):
    """The microbatches of ``lbbdm_in.pt`` (global batches, the JAX draws of t
    and noise) through ``make_train_step``, this rank's rows of each."""
    from bbdm_tpu_torch.checkpoints.from_jax import (
        latent_stats_from_jax,
        opt_state_to_jax,
        plateau_to_jax,
    )
    from bbdm_tpu_torch.models import build_model
    from bbdm_tpu_torch.training.ema import ema_init
    from bbdm_tpu_torch.training.optim import Optimizer
    from bbdm_tpu_torch.training.plateau import plateau_init
    from bbdm_tpu_torch.training.state import TrainState
    from bbdm_tpu_torch.training.step import make_train_step

    inp = torch.load(os.path.join(work, "lbbdm_in.pt"), weights_only=False)
    cfg = dict2namespace(inp["model"])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(inp["state_dict"])
    model.train()
    params = model.trainable_parameters()
    state = TrainState(step=0, params=params, ema=ema_init(params),
                       optimizer=Optimizer(cfg.BB.optimizer, params),
                       plateau=plateau_init(cfg.BB.optimizer.lr),
                       latent_stats=latent_stats_from_jax(inp["stats"]))
    step = make_train_step(model, dict2namespace(inp["training"]), dict2namespace(inp["ema"]),
                           cfg.BB.lr_scheduler)
    losses, lrs = [], []
    for x, y, t, noise in zip(inp["x"], inp["y"], inp["t"], inp["noise"]):
        out = step(state, _nchw(_rows(x, rank, size)), _nchw(_rows(y, rank, size)),
                   t=torch.from_numpy(_rows(t, rank, size)),
                   noise=_nchw(_rows(noise, rank, size)))
        losses.append(float(out["loss"]))
        lrs.append(float(out["lr"]))
    torch.save({"state_dict": model.state_dict(), "ema": state.ema, "step": state.step,
                "losses": losses, "lrs": lrs,
                "opt_state": opt_state_to_jax(state.optimizer, model),
                "plateau": plateau_to_jax(state.plateau)},
               os.path.join(work, f"lbbdm_rank{rank}_of{size}.pt"))


# ------------------------------------------------------------ VQGAN steps

def vqgan_config():
    """A tiny VQGAN (ch 64 x (1, 2), Gumbel quantizer) with a BatchNorm PatchGAN
    (ndf 8, 2 layers), ``disc_start`` 0 and the adaptive d_weight."""
    return dict2namespace(_vqgan_model())


def _vqgan_model():
    return {
        "model_type": "VQGAN",
        "VQGAN": {"params": {
            "embed_dim": 3, "n_embed": 32, "quantizer": "gumbel", "kl_weight": 5e-3,
            "ddconfig": {"double_z": False, "z_channels": 3, "resolution": VQ_SIZE,
                         "in_channels": 3, "out_ch": 3, "ch": 64, "ch_mult": [1, 2],
                         "num_res_blocks": 1, "attn_resolutions": [], "dropout": 0.0}}},
        "loss": {"disc_start": 0, "disc_factor": 1.0, "disc_weight": 0.8,
                 "codebook_weight": 1.0, "perceptual_weight": 1.0, "disc_loss": "hinge",
                 "adaptive_disc_weight": True, "use_actnorm": False, "disc_ndf": 8,
                 "disc_num_layers": 2,
                 "temperature_scheduler": {"temp_init": 1.0, "temp_min": 0.5,
                                           "anneal_rate": 0.1}},
        "optimizer": {"lr": VQ_LR, "beta1": 0.5}}


def vqgan_steps(rank, size, work):
    """``VQ_STEPS`` GAN steps from the seeded weights on global batches of
    ``VQ_BATCH``, this rank's rows of each, the Gumbel draws from a generator
    seeded alike on every rank."""
    from bbdm_tpu_torch.models import build_model
    from bbdm_tpu_torch.runners.vqgan import _adam
    from bbdm_tpu_torch.training.gan import GANTrainState, make_vqgan_train_step

    cfg = vqgan_config()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).train()
    gen, disc = dict(model.vqgan.named_parameters()), dict(model.discriminator.named_parameters())
    state = GANTrainState(step=0, gen_params=gen, disc_params=disc,
                          gen_opt=_adam(gen, VQ_LR, 0.5), disc_opt=_adam(disc, VQ_LR, 0.5),
                          lr=torch.tensor(VQ_LR))
    step = make_vqgan_train_step(model.vqgan, model.discriminator, cfg.loss)
    g = torch.Generator().manual_seed(5)
    rs = np.random.RandomState(3)
    metrics = []
    for _ in range(VQ_STEPS):
        x = rs.uniform(-1, 1, (VQ_BATCH, VQ_SIZE, VQ_SIZE, 3)).astype(np.float32)
        out = step(state, _nchw(_rows(x, rank, size)), g)
        metrics.append({k: float(v) for k, v in out.items()})
    torch.save({"metrics": metrics, "state_dict": model.state_dict()},
               os.path.join(work, f"vqgan_rank{rank}_of{size}.pt"))


def vqgan_runner(rank, size, work):
    """``VQGANRunner.train`` over one epoch of the ``single`` images (one step
    of the global batch of 4, a validation epoch, a save), then
    ``sample_to_eval`` into ``vq_of<size>``. Writes the validation losses and
    the weights to ``vq_rank<rank>_of<size>.pt``."""
    from bbdm_tpu_torch.runners.vqgan import VQGANRunner

    cfg = dict2namespace({
        "runner": "VQGANRunner",
        "training": {"n_epochs": 1, "n_steps": 100, "save_interval": 1, "sample_interval": 100,
                     "validation_interval": 1, "accumulate_grad_batches": 1},
        "testing": {"clip_denoised": False, "sample_num": 1},
        "data": {"dataset_name": "tiny", "dataset_type": "custom_single",
                 "dataset_config": {"dataset_path": os.path.join(work, "single"),
                                    "image_size": VQ_SIZE, "channels": 3, "to_normal": True,
                                    "flip": False},
                 "train": {"batch_size": VQ_BATCH, "shuffle": True},
                 "val": {"batch_size": VQ_BATCH, "shuffle": True},
                 "test": {"batch_size": VQ_BATCH}},
        "model": {"model_name": "tiny-vqgan", "mixed_precision": False, **_vqgan_model()}})
    cfg.args = SimpleNamespace(result_path=os.path.join(work, f"vq_of{size}"), seed=1234,
                               train=True, sample_to_eval=False, sample_at_start=False,
                               save_top=False, gpu_ids="-1")
    runner = VQGANRunner(cfg, device="cpu")
    validation_epoch, validations = runner.validation_epoch, []
    runner.validation_epoch = lambda *a: validations.append(validation_epoch(*a)) or \
        validations[-1]
    runner.train()
    cfg.args.sample_to_eval = True
    runner.test()
    torch.save({"validations": validations, "state_dict": runner.model.state_dict(),
                "step": runner.global_step}, os.path.join(work, f"vq_rank{rank}_of{size}.pt"))


# ------------------------------------------------------- runner scenarios

def lbbdm_runner_config(data, result, **training):
    """A tiny LBBDM (SpatialRescaler condition, eta 1, 2 draws per condition,
    two channels per GroupNorm group: see test_torch_train_step.py) over the
    PNG pairs under ``data``, with CLI-like ``args``."""
    cfg = dict2namespace({
        "runner": "BBDMRunner",
        "training": {"n_epochs": 1, "n_steps": 100, "save_interval": 1, "sample_interval": 1,
                     "validation_interval": 1, "accumulate_grad_batches": 1, **training},
        "testing": {"clip_denoised": False, "sample_num": 2},
        "data": {"dataset_name": "tiny", "dataset_type": "custom_aligned",
                 "dataset_config": {"dataset_path": data, "image_size": 16, "channels": 3,
                                    "to_normal": True, "flip": False},
                 "train": {"batch_size": 4, "shuffle": True},
                 "val": {"batch_size": 4, "shuffle": True}, "test": {"batch_size": 4}},
        "model": {
            "model_name": "tiny-lbbdm", "model_type": "LBBDM",
            "latent_before_quant_conv": False, "normalize_latent": True,
            "only_load_latent_mean_std": False, "mixed_precision": False,
            "EMA": {"use_ema": True, "ema_decay": 0.9, "update_ema_interval": 1,
                    "start_ema_step": 0},
            "CondStageParams": {"n_stages": 1, "in_channels": 3, "out_channels": 3},
            "VQGAN": {"params": {
                "ckpt_path": None, "embed_dim": 3, "n_embed": 32,
                "ddconfig": {"double_z": False, "z_channels": 3, "resolution": 16,
                             "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 2],
                             "num_res_blocks": 1, "attn_resolutions": [], "dropout": 0.0}}},
            "BB": {
                "optimizer": {"weight_decay": 0.0, "optimizer": "Adam", "lr": 1e-3,
                              "beta1": 0.9},
                "lr_scheduler": {"factor": 0.5, "patience": 10, "threshold": 1e-4,
                                 "cooldown": 10, "min_lr": 1e-7},
                "params": {
                    "mt_type": "linear", "objective": "grad", "loss_type": "l1",
                    "skip_sample": True, "sample_type": "linear", "sample_step": 4,
                    "num_timesteps": 20, "eta": 1.0, "max_var": 1.0,
                    "UNetParams": {
                        "image_size": 8, "in_channels": 6, "model_channels": 64,
                        "out_channels": 3, "num_res_blocks": 1,
                        "attention_resolutions": [2], "channel_mult": [1, 2],
                        "conv_resample": True, "dims": 2, "num_heads": 4,
                        "num_head_channels": 8, "use_scale_shift_norm": True,
                        "resblock_updown": True, "use_spatial_transformer": False,
                        "context_dim": None, "condition_key": "SpatialRescaler"}}}}})
    cfg.args = SimpleNamespace(result_path=result, seed=1234, train=bool(training),
                               sample_to_eval=not training, sample_at_start=False,
                               save_top=False, gpu_ids="-1")
    return cfg


def sample_to_eval(rank, size, work):
    """``BBDMRunner.test`` with ``--sample_to_eval`` into ``s2e_of<size>``."""
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    runner = BBDMRunner(lbbdm_runner_config(os.path.join(work, "data"),
                                            os.path.join(work, f"s2e_of{size}")), device="cpu")
    runner.test()


def train_until_stopped(rank, size, work):
    """``BBDMRunner.train`` for up to 5 epochs of one step, rank 0 with a
    profile window over step 2 and its stop file made during step 3, rank 1
    sent a SIGTERM during step 1 (ignored: rank 0 decides); each rank with its
    own result and profile directories. Writes what each rank saw to
    ``stop_rank<rank>.pt``."""
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    stop_file = os.path.join(work, "STOP")
    cfg = lbbdm_runner_config(os.path.join(work, "data"),
                              os.path.join(work, f"train_rank{rank}"), n_epochs=5,
                              sample_interval=2, stop_file=stop_file,
                              profile_dir=os.path.join(work, f"prof_rank{rank}"),
                              profile_start_step=1, profile_steps=1)
    runner = BBDMRunner(cfg, device="cpu")
    build, validations = runner.build_train_step, []

    def build_train_step():
        step = build()

        def counted(state, *a, **kw):
            out = step(state, *a, **kw)
            if rank == 0 and state.step == 3:
                open(stop_file, "w").close()
            if rank == 1 and state.step == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return counted

    validation_epoch = runner.validation_epoch
    runner.build_train_step = build_train_step
    runner.validation_epoch = lambda *a: validations.append(validation_epoch(*a)) or \
        validations[-1]
    runner.train()
    torch.save({"global_step": runner.global_step, "stop_reason": runner.stop_reason,
                "validations": validations, "stop_file_left": os.path.exists(stop_file),
                "state_dict": runner.model.state_dict()},
               os.path.join(work, f"stop_rank{rank}.pt"))


def device_cache_rows(rank, size, work):
    """``training.device_data_cache`` on this rank: the train and val loaders of
    ``BBDMRunner._build_loaders()`` (the whole set resident, this rank's rows
    gathered) against the host loaders' batches through ``_put_batch``, two
    epochs. Writes the names and the comparisons to ``cache_rank<rank>.pt``."""
    from bbdm_tpu_torch.data.device_cache import DeviceCachedLoader
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    runner = BBDMRunner(lbbdm_runner_config(os.path.join(work, "data"),
                                            os.path.join(work, f"cache_rank{rank}"),
                                            device_data_cache=True), device="cpu")
    cached, host = runner._build_loaders()[:2], runner._build_loaders(for_training=False)[:2]
    out = {"cached": [isinstance(lo, DeviceCachedLoader) for lo in cached], "names": [],
           "equal": [], "latent_stats": runner.latent_stats}
    for epoch in (0, 1):
        for c, h in zip(cached, host):
            c.set_epoch(epoch)
            h.set_epoch(epoch)
            for cb, hb in zip(c, h):
                out["names"].append((cb["x_name"], hb["x_name"]))
                out["equal"].append(all(
                    torch.equal(a, b) and a.stride() == b.stride()
                    for a, b in zip(runner._put_batch(cb), runner._put_batch(hb))))
    torch.save(out, os.path.join(work, f"cache_rank{rank}.pt"))
