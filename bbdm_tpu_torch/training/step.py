"""The train and eval steps (port of ``bbdm_tpu/training/step.py``).

One call per microbatch: the step counter increments before the loss, the
loss's gradient is summed into the parameters' ``.grad`` (not averaged over
``accumulate_grad_batches``), and on every ``accumulate``-th microbatch the
optimizer applies the summed gradient with the plateau state's learning rate
from before this update's transition, the plateau steps with this
microbatch's loss, and the gradients are cleared. The EMA steps when
``step % (update_ema_interval * accumulate) == 0``: a copy before
``start_ema_step``, the decay from it on. Nothing here reads the device back
to the host.

Data parallel (``parallel/``): each rank's loss is the mean over its rows; the
loss returned and given to the plateau is its mean over ranks, and on the
update microbatch the summed gradients are averaged over ranks (one flat
collective) before the optimizer applies them: the global batch's gradient,
as the JAX step under a data-parallel mesh takes it.
"""

from __future__ import annotations

import contextlib

import torch

from bbdm_tpu_torch.parallel import collectives
from bbdm_tpu_torch.training.ema import ema_update, swapped_in
from bbdm_tpu_torch.training.plateau import plateau_step
from bbdm_tpu_torch.training.state import TrainState


def _loss(model, state, x, y, **kw):
    if hasattr(model, "encode"):  # LBBDM
        kw["latent_stats"] = state.latent_stats
    return model.loss(x, y, **kw)[0]


def make_train_step(model, training_config, ema_config=None, lr_scheduler_config=None):
    """``train_step(state, x, y, generator=None, *, t=None, noise=None) ->
    {"loss", "lr"}`` (0-d tensors), updating ``state`` in place. ``t`` and
    ``noise`` go to ``model.loss`` (tests feed the JAX package's draws)."""
    accumulate = int(training_config.get("accumulate_grad_batches", 1))
    use_ema = ema_config is not None and ema_config.get("use_ema", False)
    ema_decay = ema_config.get("ema_decay", 0.995) if use_ema else 0.0
    ema_interval = ema_config.get("update_ema_interval", 1) if use_ema else 1
    start_ema_step = ema_config.get("start_ema_step", 0) if use_ema else 0
    sched = lr_scheduler_config

    def train_step(state: TrainState, x, y, generator=None, *, t=None, noise=None):
        step = state.step + 1
        loss = _loss(model, state, x, y, generator=generator, t=t, noise=noise)
        loss.backward()
        loss = collectives.mean(loss.detach())
        state.step = step
        if step % accumulate == 0:
            opt = state.optimizer
            missing = [k for k, p in zip(opt.names, opt.params) if p.grad is None]
            if missing:
                raise RuntimeError(f"no gradient reached {len(missing)} trainable parameters "
                                   f"(first: {missing[0]}): the graph was cut")
            lr = state.plateau.lr  # this update's: the transition below comes after it
            grads = [p.grad for p in opt.params]
            collectives.all_reduce_mean_(grads)
            opt.update(grads, lr)
            if sched is not None:
                state.plateau = plateau_step(
                    state.plateau, loss, factor=sched.factor, patience=sched.patience,
                    threshold=sched.threshold, cooldown=sched.cooldown, min_lr=sched.min_lr)
            for p in opt.params:
                p.grad = None
        if use_ema and step % (ema_interval * accumulate) == 0:
            ema_update(state.ema, state.params, ema_decay, step >= start_ema_step)
        return {"loss": loss, "lr": state.plateau.lr}

    return train_step


def make_eval_step(model):
    """``eval_step(state, x, y, generator=None) -> loss`` with the EMA weights
    (the model's mode as it is: the JAX eval loss runs with ``train=True``),
    the mean over ranks."""

    def eval_step(state: TrainState, x, y, generator=None):
        weights = (swapped_in(state.params, state.ema) if state.ema is not None
                   else contextlib.nullcontext())
        with torch.no_grad(), weights:
            return collectives.mean(_loss(model, state, x, y, generator=generator))

    return eval_step
