"""The rank processes of tests/test_torch_sharding.py (torch and the port only:
no JAX, so that a spawned rank starts quickly).

:func:`run` is a rank of a gloo group on the CPU. Two ranks run the FSDP and
the tensor-parallel scenarios (each on its grid: 2 x 1 or 1 x 2), four ranks
the 2 x 2 one; each rank writes what it computed under the work directory,
the sharded state gathered whole. The test calls the same functions in its own
process, outside any group, for the one-rank runs they are held against.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
from torch_parallel_worker import VQ_BATCH, VQ_LR, VQ_SIZE, VQ_STEPS, _nchw, _rows
from torch_parallel_worker import lbbdm_runner_config, vqgan_config

from bbdm_tpu_torch import parallel
from bbdm_tpu_torch.config import dict2namespace
from bbdm_tpu_torch.parallel.mesh import make_grid
from bbdm_tpu_torch.parallel.sharding import place_state


def run(rank: int, size: int, port: int, work: str) -> None:
    # one thread per rank: ranks whose OpenMP pools share the cores spin against
    # each other at every collective
    torch.set_num_threads(1)
    parallel.initialize(rank, size, init_method=f"tcp://127.0.0.1:{port}", local_size=size,
                        backend="gloo")
    try:
        if size == 4:
            lbbdm_steps(rank, work, "grid", model_parallel=2, fsdp=True, microbatches=2)
            return
        lbbdm_steps(rank, work, "fsdp", fsdp=True)
        lbbdm_steps(rank, work, "mp", model_parallel=2)
        vqgan_steps(rank, work, "fsdp", fsdp=True)
        vqgan_steps(rank, work, "mp", model_parallel=2)
        runner_lifecycle(rank, work, "fsdp", fsdp=True)
        runner_lifecycle(rank, work, "mp", model_parallel=2)
        sample_to_eval(rank, work, "mp", model_parallel=2)
    finally:
        parallel.shutdown()


def lbbdm_steps(rank, work, tag, *, model_parallel=1, fsdp=False, microbatches=None):
    """The microbatches of ``lbbdm_in.pt`` (global batches, the JAX draws of t
    and noise) through ``make_train_step`` on the sharded state, this rank's
    data index's rows of each; the bytes the rank keeps while an update
    accumulates."""
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
    g = make_grid(model_parallel)
    state.sharding = place_state(model, state, model_parallel=model_parallel, fsdp=fsdp)
    step = make_train_step(model, dict2namespace(inp["training"]), dict2namespace(inp["ema"]),
                           cfg.BB.lr_scheduler)
    rows = lambda a: _rows(a, g.data_index, g.data_size)
    losses, lrs, kept = [], [], None
    batches = list(zip(inp["x"], inp["y"], inp["t"], inp["noise"]))[:microbatches]
    for x, y, t, noise in batches:
        out = step(state, _nchw(rows(x)), _nchw(rows(y)), t=torch.from_numpy(rows(t)),
                   noise=_nchw(rows(noise)))
        losses.append(float(out["loss"]))
        lrs.append(float(out["lr"]))
        if kept is None:
            kept = state.sharding.persistent_bytes()
    with state.sharding.gathered():
        torch.save({"state_dict": model.state_dict(), "ema": dict(state.ema),
                    "step": state.step, "losses": losses, "lrs": lrs, "bytes": kept,
                    "opt_state": opt_state_to_jax(state.optimizer, model),
                    "plateau": plateau_to_jax(state.plateau)},
                   os.path.join(work, f"lbbdm_{tag}_rank{rank}.pt"))


def vqgan_steps(rank, work, tag, *, model_parallel=1, fsdp=False):
    """``VQ_STEPS`` GAN steps from the seeded weights on global batches of
    ``VQ_BATCH`` (``torch_parallel_worker.vqgan_steps``), on the sharded state;
    one rank outside a group with ``tag`` "one"."""
    from bbdm_tpu_torch.models import build_model
    from bbdm_tpu_torch.runners.vqgan import _adam
    from bbdm_tpu_torch.training.gan import GANTrainState, make_vqgan_train_step

    cfg = vqgan_config()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).train()
    gen, disc = dict(model.vqgan.named_parameters()), dict(model.discriminator.named_parameters())
    state = GANTrainState(step=0, gen_params=gen, disc_params=disc,
                          gen_opt=_adam(gen, VQ_LR, 0.5), disc_opt=_adam(disc, VQ_LR, 0.5),
                          lr=torch.tensor(VQ_LR))
    g = make_grid(model_parallel)
    state.sharding = place_state(model, state, model_parallel=model_parallel, fsdp=fsdp)
    step = make_vqgan_train_step(model.vqgan, model.discriminator, cfg.loss)
    gen_ = torch.Generator().manual_seed(5)
    rs = np.random.RandomState(3)
    metrics = []
    for _ in range(VQ_STEPS):
        x = rs.uniform(-1, 1, (VQ_BATCH, VQ_SIZE, VQ_SIZE, 3)).astype(np.float32)
        out = step(state, _nchw(_rows(x, g.data_index, g.data_size)), gen_)
        metrics.append({k: float(v) for k, v in out.items()})
    with state.sharding.gathered() if state.sharding is not None else contextlib.nullcontext():
        torch.save({"metrics": metrics, "state_dict": model.state_dict()},
                   os.path.join(work, f"vqgan_{tag}_rank{rank}.pt"))


def runner_config(work, tag, rank, **training):
    """The tiny LBBDM runner of ``torch_parallel_worker`` training one epoch of
    one step with a mid-training sample grid, into ``run_<tag>_rank<rank>``."""
    cfg = lbbdm_runner_config(os.path.join(work, "data"),
                              os.path.join(work, f"run_{tag}_rank{rank}"), n_epochs=1,
                              **training)
    cfg.model.EMA.start_ema_step = 0
    return cfg


def runner_lifecycle(rank, work, tag, **training):
    """``BBDMRunner.train`` over one epoch with ``training`` (a sample grid after
    its step, validation, a checkpoint); writes the global step."""
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    runner = BBDMRunner(runner_config(work, tag, rank, **training), device="cpu")
    runner.train()
    torch.save({"global_step": runner.global_step, "grid": (runner.grid.data_size,
                                                            runner.grid.model_size)},
               os.path.join(work, f"run_{tag}_rank{rank}.pt"))


def sample_to_eval(rank, work, tag, **training):
    """``BBDMRunner.test`` with ``--sample_to_eval`` into ``s2e_<tag>`` (a tree
    the ranks share); writes the PNGs this rank wrote."""
    from bbdm_tpu_torch.runners import bbdm

    cfg = lbbdm_runner_config(os.path.join(work, "data"), os.path.join(work, f"s2e_{tag}"),
                              **training)
    cfg.args.train, cfg.args.sample_to_eval = False, True
    written = []
    save = bbdm.save_single_image
    bbdm.save_single_image = lambda img, path, name, **kw: written.append(name) or \
        save(img, path, name, **kw)
    try:
        bbdm.BBDMRunner(cfg, device="cpu").test()
    finally:
        bbdm.save_single_image = save
    torch.save(written, os.path.join(work, f"s2e_{tag}_rank{rank}.pt"))
