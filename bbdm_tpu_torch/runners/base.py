"""BaseRunner: the training and test lifecycle of ``bbdm_tpu/runners/base.py``
on one process and one device.

``__init__`` builds the result tree, writes ``checkpoint/config.yaml`` and
opens the TensorBoard writer (when the config carries CLI ``args``), builds
the model on the device and, under ``args.train``, the train state (optimizer,
plateau, EMA), then loads ``model.model_load_path`` (and
``model.optim_sche_load_path`` when training). :meth:`train` runs the epoch
loop of ``bbdm_tpu/runners/base.py:394-682``: one train step per microbatch,
``loss/train`` logged one step late, a validation step every 50 steps and an
epoch validation every ``validation_interval`` epochs, sample grids with the
EMA weights every ``sample_interval`` epochs' worth of steps, checkpoints in
the JAX package's layout, the graceful stop (first SIGTERM, a stop file,
``training.max_wall_sec``; a second SIGTERM raises) and the exception save.
:meth:`test` runs ``sample_to_eval`` over the test set (the val set when the
test set has no full batch) or the single-batch grids.

``training.fuse_small_leaves`` and ``training.device_data_cache`` (TPU launch
and transfer optimizations with identical results) are ignored;
``training.model_parallel`` > 1, ``training.fsdp`` and
``training.profile_dir`` raise.
"""

from __future__ import annotations

import contextlib
import os
import signal
import time
import traceback
from abc import ABC, abstractmethod

import numpy as np
import torch

from bbdm_tpu_torch.checkpoints.from_jax import (
    jax_tree_from_state_dict,
    opt_state_to_jax,
    plateau_to_jax,
)
from bbdm_tpu_torch.checkpoints.io import save_checkpoint
from bbdm_tpu_torch.config import ConfigNode, device_from_gpu_ids, save_config
from bbdm_tpu_torch.models.factory import resolve_device
from bbdm_tpu_torch.runners.utils import make_dir, make_save_dirs, remove_file
from bbdm_tpu_torch.training.ema import ema_init, swapped_in
from bbdm_tpu_torch.training.plateau import plateau_init
from bbdm_tpu_torch.training.state import TrainState
from bbdm_tpu_torch.training.step import make_eval_step, make_train_step
from bbdm_tpu_torch.utils.tboard import SummaryWriter

# sampling draws come from their own stream (bbdm_tpu/runners/base.py:165-174
# folds this constant into the seed), apart from the weight-init stream; the
# training draws (t, noise) from a third
_SAMPLE_STREAM = 0x5A4D50
_TRAIN_STREAM = 0x545241


def _stream(device, constant: int, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed((constant << 32) + (seed & 0xFFFFFFFF))


class BaseRunner(ABC):
    def __init__(self, config, *, device=None, seed=None):
        """``device`` defaults to ``--gpu_ids`` (``config.args``), else the CUDA
        card (see ``models/factory.resolve_device``); ``seed`` to ``--seed``,
        else 0."""
        self.config = config
        args = config.get("args")
        self.seed = seed if seed is not None else (args.seed if args is not None else 0)
        if device is None and args is not None:
            device = device_from_gpu_ids(args.gpu_ids)
        self.device = resolve_device(device)
        self.is_training = bool(args is not None and args.train)
        self.global_epoch = 0
        self.global_step = -1 if getattr(args, "sample_at_start", False) else 0
        self.topk_checkpoints = {}
        self.writer = None
        if args is not None:
            result = config.result = ConfigNode()
            (result.result_path, result.image_path, result.ckpt_path, result.log_path,
             result.sample_path, result.sample_to_eval_path) = make_save_dirs(
                args, prefix=config.data.dataset_name, suffix=config.model.model_name)
            self.logger("save training results to " + result.result_path)
            save_config(config, os.path.join(result.ckpt_path, "config.yaml"))
            self.writer = SummaryWriter(result.log_path)
        self.use_ema = config.model.EMA.use_ema if "EMA" in config.model else False
        self.model = self.initialize_model(
            config, torch.Generator(self.device).manual_seed(self.seed))
        self.generator = _stream(self.device, _SAMPLE_STREAM, self.seed)
        self.state = None
        if self.is_training:
            self._check_training_config()
            self.train_generator = _stream(self.device, _TRAIN_STREAM, self.seed)
            self.state = self.build_initial_state()
        self.load_model_from_checkpoint()

    def logger(self, msg):
        print(msg, flush=True)

    def _check_training_config(self):
        training = self.config.training
        if int(training.get("model_parallel", 1) or 1) > 1 or training.get("fsdp", False):
            raise NotImplementedError("training.model_parallel > 1 and training.fsdp are not "
                                      "ported (ROADMAP.md §1 item 6)")
        if training.get("profile_dir", None):
            raise NotImplementedError("training.profile_dir is not ported (ROADMAP.md §1 item 9)")
        if training.get("fuse_small_leaves", False):
            self.logger("training.fuse_small_leaves is ignored: a TPU launch optimization with "
                        "identical results; the optimizer state keeps the per-leaf layout")

    def build_initial_state(self):
        """The train state (hook): for the BBDM the optimizer, plateau and EMA
        over the model's trainable parameters (``bbdm_tpu/runners/base.py:119-135``)."""
        params = self.model.trainable_parameters()
        count = lambda ps: sum(p.numel() for p in ps)
        self.logger("Total Number of parameter: %.2fM" % (count(self.model.parameters()) / 1e6))
        self.logger("Trainable Number of parameter: %.2fM" % (count(params.values()) / 1e6))
        optimizer, self.lr_scheduler_config, init_lr = self.initialize_optimizer_scheduler(
            params, self.config)
        return TrainState(step=self.global_step, params=params,
                          ema=ema_init(params) if self.use_ema else None, optimizer=optimizer,
                          plateau=plateau_init(init_lr, self.device))

    def build_train_step(self):
        """The train step (hook): ``step(state, x, y, generator) -> {"loss", ...}``,
        one microbatch, updating the state in place."""
        training = self.config.training
        return make_train_step(self.model, training,
                               self.config.model.EMA if "EMA" in self.config.model else None,
                               self.lr_scheduler_config)

    def build_eval_step(self):
        """The eval step (hook): ``step(state, x, y, generator) -> loss``."""
        return make_eval_step(self.model)

    @abstractmethod
    def initialize_model(self, config, generator: torch.Generator):
        """The model on ``self.device``, random weights drawn from ``generator``."""

    @abstractmethod
    def initialize_optimizer_scheduler(self, params: dict, config):
        """(optimizer over ``params``, lr_scheduler config node, initial lr)."""

    @abstractmethod
    def load_model_from_checkpoint(self):
        """Load ``config.model.model_load_path`` when it is set."""

    @abstractmethod
    def sample(self, batch, sample_path, stage="train"):
        """Sample one batch to PNG grids."""

    @abstractmethod
    def sample_to_eval(self, test_loader, sample_path):
        """Sweep the test set for offline metric evaluation."""

    # ------------------------------------------------------------- batches

    def _build_loaders(self):
        """(train, val, test) loaders as ``bbdm_tpu/runners/base.py:359-377``
        builds them: train and val shuffled by ``seed + epoch`` (``set_epoch``),
        the test loader unshuffled; every loader drops its last partial batch."""
        from bbdm_tpu_torch.data import DataLoader, get_dataset

        train_ds, val_ds, test_ds = get_dataset(self.config.data)
        data, seed = self.config.data, self.config.args.seed
        train_loader = DataLoader(train_ds, data.train.batch_size,
                                  shuffle=data.train.get("shuffle", True), seed=seed)
        val_loader = DataLoader(val_ds, data.val.batch_size,
                                shuffle=data.val.get("shuffle", True), seed=seed)
        test_loader = DataLoader(test_ds, data.test.batch_size, shuffle=False, seed=seed)
        return train_loader, val_loader, test_loader

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """NHWC float batch -> NCHW-contiguous fp32 on the device; on the card
        through pinned memory without waiting (a pageable copy would wait for
        the queued steps)."""
        t = torch.from_numpy(np.asarray(a, np.float32))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        else:
            t = t.to(self.device)
        return t.permute(0, 3, 1, 2).contiguous()

    def _put_batch(self, batch):
        return self._to_device(batch["x"]), self._to_device(batch["x_cond"])

    # ---------------------------------------------------------- checkpoints

    def get_checkpoint_states(self, stage="epoch_end"):
        """(model states, optimizer states) as ``bbdm_tpu/runners/base.py:230-250``
        writes them (hook): an ``epoch_end`` save resumes at the next epoch, an
        exception or graceful-stop save redoes the partial epoch."""
        sd = self.model.state_dict()
        model_states = {
            "step": int(self.state.step),
            "model": jax_tree_from_state_dict(sd),
            "epoch": self.global_epoch + 1 if stage == "epoch_end" else self.global_epoch,
        }
        if self.use_ema:
            # the JAX EMA tree also holds the frozen VQGAN, which never moves
            model_states["ema"] = jax_tree_from_state_dict({**sd, **self.state.ema})
        optim_states = {"optimizer": [opt_state_to_jax(self.state.optimizer, self.model)],
                        "scheduler": [plateau_to_jax(self.state.plateau)]}
        return model_states, optim_states

    def _save_top_checkpoint(self, average_loss, epoch, model_states, optim_states):
        """Single-slot best-val-loss checkpoint (``bbdm_tpu/runners/base.py:684-710``)."""
        ckpt_path = self.config.result.ckpt_path
        top = self.topk_checkpoints.get("top")
        if top is not None and not (average_loss < top["loss"]):
            return
        if top is not None:
            remove_file(os.path.join(ckpt_path, top["model_ckpt_name"]))
            remove_file(os.path.join(ckpt_path, top["optim_sche_ckpt_name"]))
        self.logger(f"saving top checkpoint: average_loss={average_loss} epoch={epoch + 1}")
        top = self.topk_checkpoints["top"] = {
            "loss": average_loss,
            "model_ckpt_name": f"top_model_epoch_{epoch + 1}.ckpt",
            "optim_sche_ckpt_name": f"top_optim_sche_epoch_{epoch + 1}.ckpt"}
        save_checkpoint(model_states, os.path.join(ckpt_path, top["model_ckpt_name"]))
        save_checkpoint(optim_states, os.path.join(ckpt_path, top["optim_sche_ckpt_name"]))

    def _save_checkpoints(self, epoch, model_states, optim_states, average_loss):
        """``latest_*_{epoch + 1}`` (the older ``latest_*`` removed), ``last_*``,
        and under ``--save_top`` the top pair."""
        ckpt_path = self.config.result.ckpt_path
        for temp in range(epoch + 1):
            remove_file(os.path.join(ckpt_path, f"latest_model_{temp}.ckpt"))
            remove_file(os.path.join(ckpt_path, f"latest_optim_sche_{temp}.ckpt"))
        for name, states in ((f"latest_model_{epoch + 1}.ckpt", model_states),
                             (f"latest_optim_sche_{epoch + 1}.ckpt", optim_states),
                             ("last_model.ckpt", model_states),
                             ("last_optim_sche.ckpt", optim_states)):
            save_checkpoint(states, os.path.join(ckpt_path, name))
        if self.config.args.save_top:
            self._save_top_checkpoint(average_loss, epoch, model_states, optim_states)

    # ------------------------------------------------------- val and sample

    def validation_step(self, val_batch, epoch, step):
        x, y = self._put_batch(val_batch)
        loss = float(self._eval_step(self.state, x, y, self.train_generator))
        self.writer.add_scalar("loss/val_step", loss, step)
        return loss

    def validation_epoch(self, val_loader, epoch):
        losses = [float(self._eval_step(self.state, *self._put_batch(b), self.train_generator))
                  for b in val_loader]
        average_loss = sum(losses) / max(len(losses), 1)
        self.writer.add_scalar("val_epoch/loss", average_loss, epoch)
        return average_loss

    def sample_step(self, train_batch, val_batch):
        """Sample grids with the EMA weights (``bbdm_tpu/runners/base.py:349-355``)."""
        sample_path = make_dir(os.path.join(self.config.result.image_path,
                                            str(self.global_step)))
        with (swapped_in(self.state.params, self.state.ema) if self.use_ema
              else contextlib.nullcontext()):
            self.sample(train_batch, sample_path, stage="train")
            self.sample(val_batch, sample_path, stage="val")

    # ---------------------------------------------------------------- train

    def train(self):
        """``bbdm_tpu/runners/base.py:394-682`` on one process (see the module
        docstring). ``self.stop_reason`` says why it ended (None: ran to the end)."""
        if self.state is None:
            raise RuntimeError("train() needs a runner built for training (args.train)")
        self.logger(self.__class__.__name__)
        train_loader, val_loader, _ = self._build_loaders()
        epoch_length = len(train_loader)
        training = self.config.training
        self.logger(f"start training {self.config.model.model_name} on "
                    f"{self.config.data.dataset_name}, {epoch_length} iters per epoch")
        train_step = self.build_train_step()
        self._eval_step = self.build_eval_step()
        sample_every = max(int(training.sample_interval * epoch_length), 1)
        val_iter = None

        def next_val_batch():
            nonlocal val_iter
            for _ in range(2):
                if val_iter is None:
                    val_iter = iter(val_loader)
                try:
                    return next(val_iter)
                except StopIteration:
                    val_iter = None
            raise RuntimeError("the val set has no full batch")

        stop_reason = None
        unwinding = False
        train_t0 = time.monotonic()
        max_wall = training.get("max_wall_sec", None)
        stop_file = training.get("stop_file",
                                 os.path.join(self.config.result.result_path, "STOP"))

        def poll_stop():
            nonlocal stop_reason
            if stop_reason is None:
                if max_wall is not None and time.monotonic() - train_t0 > float(max_wall):
                    stop_reason = f"wall budget ({max_wall}s) exhausted"
                elif stop_file and os.path.exists(stop_file):
                    stop_reason = f"stop file {stop_file} present"
            return stop_reason

        def on_sigterm(signum, frame):
            nonlocal stop_reason
            if unwinding or stop_reason is not None:
                raise KeyboardInterrupt("SIGTERM")
            stop_reason = "SIGTERM"
            self.logger("SIGTERM: stopping at the next step boundary "
                        "(send again to force the emergency-save raise)")

        old_handler = None
        try:
            old_handler = signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:  # not the main thread
            pass

        average_loss = float("nan")
        self.model.train()
        try:
            for epoch in range(self.global_epoch, training.n_epochs):
                if self.global_step > training.n_steps:
                    break
                train_loader.set_epoch(epoch)
                val_loader.set_epoch(epoch)
                self.global_epoch = epoch
                start_time = time.time()
                pending_log = None  # (step, metrics): logged one step late
                for train_batch in train_loader:
                    x, y = self._put_batch(train_batch)
                    metrics = train_step(self.state, x, y, self.train_generator)
                    self.global_step += 1
                    # the previous step's loss: reading it waits for that step
                    # only, not for the one just queued
                    if pending_log is not None:
                        self.writer.add_scalar("loss/train", float(pending_log[1]["loss"]),
                                               pending_log[0])
                    pending_log = (self.global_step, metrics)
                    if self.global_step % 50 == 0:
                        self.validation_step(next_val_batch(), epoch, self.global_step)
                    if self.global_step % sample_every == 0:
                        self.sample_step(train_batch, next_val_batch())
                    if poll_stop():
                        break
                if pending_log is not None:
                    self.writer.add_scalar("loss/train", float(pending_log[1]["loss"]),
                                           pending_log[0])
                self.logger(f"training time: {int(round(time.time() - start_time))}s "
                            f"(epoch {epoch + 1})")

                if stop_reason is None and ((epoch + 1) % training.validation_interval == 0
                                            or (epoch + 1) == training.n_epochs):
                    self.logger("validating epoch...")
                    average_loss = self.validation_epoch(val_loader, epoch)
                    self.logger(f"validating epoch success (avg loss {average_loss:.6f})")

                if (stop_reason is not None or (epoch + 1) % training.save_interval == 0
                        or (epoch + 1) == training.n_epochs
                        or self.global_step > training.n_steps):
                    if stop_reason is not None:
                        self.logger(f"graceful stop ({stop_reason}): saving latest checkpoint, "
                                    "then returning cleanly")
                    self.logger("saving latest checkpoint...")
                    model_states, optim_states = self.get_checkpoint_states(
                        stage="graceful_stop" if stop_reason is not None else "epoch_end")
                    self._save_checkpoints(epoch, model_states, optim_states, average_loss)
                    del model_states, optim_states

                if stop_reason is not None:
                    if stop_file and os.path.exists(stop_file):
                        os.remove(stop_file)  # so that a resume does not stop at once
                    break
        except BaseException as e:
            unwinding = True
            self.logger("exception save model start....")
            model_states, optim_states = self.get_checkpoint_states(stage="exception")
            ckpt_path = self.config.result.ckpt_path
            save_checkpoint(model_states, os.path.join(ckpt_path, "last_model.ckpt"))
            save_checkpoint(optim_states, os.path.join(ckpt_path, "last_optim_sche.ckpt"))
            self.logger("exception save model success!")
            print("str(e):", str(e))
            traceback.print_exc()
            raise  # a non-zero exit for the supervisor
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
            self.model.eval()
            self.stop_reason = stop_reason

    # ----------------------------------------------------------------- test

    def test(self):
        """``bbdm_tpu/runners/base.py:714-744`` on one process."""
        _, val_loader, test_loader = self._build_loaders()
        if len(test_loader) == 0:
            test_loader = val_loader
        if self.config.args.sample_to_eval:
            self.sample_to_eval(test_loader, self.config.result.sample_to_eval_path)
            return
        for i, test_batch in enumerate(test_loader):
            self.sample(test_batch, os.path.join(self.config.result.sample_path, str(i)),
                        stage="test")
            break
