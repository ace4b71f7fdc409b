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
loss returned and given to the plateau is its mean over the data group, and on
the update microbatch the summed gradients are averaged over it (one flat
collective) before the optimizer applies them: the global batch's gradient,
as the JAX step under a data-parallel mesh takes it.

Sharded (``training.fsdp`` or ``model_parallel``, ``state.sharding`` from
``parallel/sharding.py``): the microbatch runs on the step form of the leaves
(each gathered over the data axis), and after its backward each gradient is
reduce-scattered over the data group into an fp32 shard accumulator, as JAX
keeps its accumulation buffer sharded; the optimizer, the plateau and the EMA
then run on the shards.

``debug_nan`` (``training.debug_nan``): the step raises FloatingPointError,
naming it, at the first non-finite global loss or averaged gradient; only
then does it read the device back.
"""

from __future__ import annotations

import contextlib

import torch

from bbdm_tpu_torch.parallel import collectives
from bbdm_tpu_torch.training.ema import ema_update, swapped_in
from bbdm_tpu_torch.training.plateau import plateau_step
from bbdm_tpu_torch.training.state import TrainState
from bbdm_tpu_torch.utils.spans import span


def _loss(model, state, x, y, **kw):
    if hasattr(model, "encode"):  # LBBDM
        kw["latent_stats"] = state.latent_stats
    return model.loss(x, y, **kw)[0]


def _check_finite(step: int, what: str, tensors: list) -> None:
    finite = torch.stack([torch.isfinite(t).all() for t in tensors]).all()
    if not bool(finite):
        raise FloatingPointError(f"debug_nan: non-finite {what} at step {step}")


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
    debug_nan = bool(training_config.get("debug_nan", False))

    def cut(names: list):
        return RuntimeError(f"no gradient reached {len(names)} trainable parameters "
                            f"(first: {names[0]}): the graph was cut")

    def sharded_microbatch(state, opt, x, y, kw):
        """The loss on the step form; the gradients summed into the shard accumulator."""
        sharding = state.sharding
        with sharding.step_form():
            with span("train.forward"):
                loss = _loss(model, state, x, y, **kw)
            global_loss = collectives.mean(loss.detach())
            if debug_nan:
                _check_finite(state.step + 1, "loss", [global_loss])
            with span("train.backward"):
                loss.backward()
            missing = [k for k, p in zip(opt.names, opt.params) if p.grad is None]
            if missing:
                raise cut(missing)
            grads = sharding.reduce(opt.params, [p.grad for p in opt.params])
        if sharding.accum is None or accumulate == 1:
            sharding.accum = grads
        else:
            torch._foreach_add_(sharding.accum, grads)
        return global_loss

    def train_step(state: TrainState, x, y, generator=None, *, t=None, noise=None):
        with span("train.step"):
            step = state.step + 1
            opt = state.optimizer
            kw = dict(generator=generator, t=t, noise=noise)
            if state.sharding is not None:
                loss = sharded_microbatch(state, opt, x, y, kw)
            else:
                with span("train.forward"):
                    loss = _loss(model, state, x, y, **kw)
                global_loss = collectives.mean(loss.detach())
                if debug_nan:
                    _check_finite(step, "loss", [global_loss])
                with span("train.backward"):
                    loss.backward()
                loss = global_loss
            state.step = step
            if step % accumulate == 0:
                with span("train.update"):
                    update(state, opt, step, loss)
            return {"loss": loss, "lr": state.plateau.lr}

    def update(state, opt, step, loss):
        """The update microbatch's optimizer, plateau and gradients' clearing,
        and the EMA, whose interval is a whole number of updates."""
        lr = state.plateau.lr  # this update's: the transition below comes after it
        if state.sharding is not None:
            grads, state.sharding.accum = state.sharding.accum, None
        else:
            missing = [k for k, p in zip(opt.names, opt.params) if p.grad is None]
            if missing:
                raise cut(missing)
            grads = [p.grad for p in opt.params]
            collectives.all_reduce_mean_(grads)
        if debug_nan:
            _check_finite(step, "averaged gradient", grads)
        opt.update(grads, lr)
        if sched is not None:
            state.plateau = plateau_step(
                state.plateau, loss, factor=sched.factor, patience=sched.patience,
                threshold=sched.threshold, cooldown=sched.cooldown, min_lr=sched.min_lr)
        for p in opt.params:
            p.grad = None
        if use_ema and step % (ema_interval * accumulate) == 0:
            ema_update(state.ema, state.params, ema_decay, step >= start_ema_step)

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
