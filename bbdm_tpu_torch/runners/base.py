"""BaseRunner: the training and test lifecycle of ``bbdm_tpu/runners/base.py``,
on one rank or data parallel over several (``parallel/``).

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
With ``training.profile_dir``, rank 0 records a ``torch.profiler`` trace
(CPU and CUDA activities) of global steps ``(profile_start_step,
profile_start_step + profile_steps]`` (defaults 10 and 5) and writes it there
as a chrome trace. :meth:`test` runs ``sample_to_eval`` over the test set
(the val set when the test set has no full batch) or the single-batch grids.

Data parallel, as the JAX runner on a data-parallel mesh: every rank builds
the same weights from the seed and loads the same checkpoint, then takes rank
0's parameters and buffers (one broadcast); each rank trains, validates and
samples its rows of each batch (``data/loader.py``), with the reductions of
``training/step.py`` and ``training/gan.py``. Rank 0 alone logs, makes the
result tree, writes ``config.yaml``, TensorBoard, checkpoints (the exception
save too) and the mid-training and test grids, and decides the graceful stop,
which it broadcasts at each step boundary (a first SIGTERM on another rank is
ignored). ``sample_to_eval`` writes each rank's own files; each node's first
rank makes the directories, and a barrier follows them and ends :meth:`test`.

FSDP and tensor parallelism (``training.fsdp``, ``training.model_parallel``),
as the JAX runner on a ``data x model`` mesh: the ranks form the grid of
``parallel/mesh.py`` (model peers take the same rows, so the loader splits
the node's batch over its data ranks), and after the broadcast the train
state becomes this rank's shards (``parallel/sharding.py``), a resume
included. Sampling, validation and checkpoints gather the whole weights first;
that gather is a collective, so every rank enters it where rank 0 alone then
samples or writes (JAX's ``_cross_host_state`` rule). Checkpoints keep the
full JAX layout.

``training.mesh_devices`` (the JAX mesh's width) must equal the number of
ranks, which ``--gpu_ids`` and the nodes set. ``training.debug_nan`` makes
the train step raise at the first non-finite loss or averaged gradient, and
turns on autograd's anomaly mode for the length of :meth:`train`, which names
the backward op that made one.

``training.device_data_cache`` (``data/device_cache.py``): :meth:`train`
keeps the train and val sets on the card and gathers each batch there (the
latent-statistics pass of ``runners/bbdm.py`` shares the train set's copy, so
it is decoded once); :meth:`test` and ``sample_to_eval`` build none.
For the BBDM runner ``training.fuse_small_leaves`` changes only the optimizer
state's checkpoint layout (:meth:`fuse_threshold`): the update runs every
leaf in one ``torch._foreach_*`` call either way.
"""

from __future__ import annotations

import contextlib
import os
import signal
import time
import traceback
from abc import ABC, abstractmethod
from typing import Optional

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
from bbdm_tpu_torch.parallel import collectives, is_main, world
from bbdm_tpu_torch.parallel.mesh import make_grid
from bbdm_tpu_torch.parallel.sharding import place_state
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
        """``device`` defaults to this rank's entry of ``--gpu_ids``
        (``config.args``), else the CUDA card (see
        ``models/factory.resolve_device``); ``seed`` to ``--seed``, else 0."""
        self.config = config
        self.world = world()
        self.is_main = is_main()
        args = config.get("args")
        self.seed = seed if seed is not None else (args.seed if args is not None else 0)
        if device is None and args is not None:
            devices = device_from_gpu_ids(args.gpu_ids)
            device = devices[self.world.local_rank if len(devices) > 1 else 0]
        self.device = resolve_device(device)
        self.is_training = bool(args is not None and args.train)
        self.global_epoch = 0
        self.global_step = -1 if getattr(args, "sample_at_start", False) else 0
        self.topk_checkpoints = {}
        self.writer = None
        self._resident = {}  # stage -> the device cache's copy of its set
        if args is not None:
            result = config.result = ConfigNode()
            (result.result_path, result.image_path, result.ckpt_path, result.log_path,
             result.sample_path, result.sample_to_eval_path) = make_save_dirs(
                args, prefix=config.data.dataset_name, suffix=config.model.model_name,
                make=self.is_main)
            self.logger("save training results to " + result.result_path)
            if self.is_main:
                save_config(config, os.path.join(result.ckpt_path, "config.yaml"))
                self.writer = SummaryWriter(result.log_path)
        self.use_ema = config.model.EMA.use_ema if "EMA" in config.model else False
        training = config.get("training") or ConfigNode()
        self.model_parallel = int(training.get("model_parallel", 1) or 1)
        self.fsdp = bool(training.get("fsdp", False))
        self._check_mesh_devices(training.get("mesh_devices", None))
        self.grid = make_grid(self.model_parallel)
        self.model = self.initialize_model(
            config, torch.Generator(self.device).manual_seed(self.seed))
        self.generator = _stream(self.device, _SAMPLE_STREAM, self.seed)
        self.state = None
        if self.is_training:
            self.train_generator = _stream(self.device, _TRAIN_STREAM, self.seed)
            self.state = self.build_initial_state()
        self.load_model_from_checkpoint()
        self.broadcast_state()
        if self.state is not None:
            self.state.sharding = place_state(self.model, self.state,
                                              model_parallel=self.model_parallel,
                                              fsdp=self.fsdp)

    def logger(self, msg):
        if self.is_main:
            print(msg, flush=True)

    def broadcast_state(self):
        """Rank 0's parameters and buffers, and EMA, on every rank (data parallel)."""
        collectives.broadcast_module(self.model)
        if self.state is not None and getattr(self.state, "ema", None) is not None:
            collectives.broadcast_(list(self.state.ema.values()))

    def _check_mesh_devices(self, n):
        """``training.mesh_devices``: the JAX mesh's width, here the number of ranks."""
        if not n:
            return
        if int(n) != self.world.size:
            raise ValueError(f"training.mesh_devices={n} but the run has {self.world.size} "
                             "ranks (--gpu_ids and the nodes set the width)")
        self.logger(f"training.mesh_devices={n}: the {self.world.size} ranks of the run")

    def full_weights(self):
        """Every leaf of the train state whole for the block (a collective when
        it is sharded: every rank enters)."""
        sharding = getattr(self.state, "sharding", None)
        return sharding.gathered() if sharding is not None else contextlib.nullcontext()

    def fuse_threshold(self):
        """The bucket threshold of the optimizer state's checkpoint layout
        under ``training.fuse_small_leaves`` (``checkpoints/from_jax.py``), or
        None for the per-leaf layout (hook: the JAX VQGAN runner ignores the
        option)."""
        return None

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

    def _loader(self, dataset, batch_size, shuffle):
        """This rank's loader: its node's shard, its data index's rows of each
        node batch (the node's model peers take the same rows)."""
        from bbdm_tpu_torch.data import DataLoader

        w, mp = self.world, self.grid.model_size
        return DataLoader(dataset, batch_size, shuffle=shuffle, seed=self.config.args.seed,
                          shard_count=w.nodes, shard_index=w.node,
                          local_count=w.local_size // mp, local_index=w.local_rank // mp)

    def _build_loaders(self, for_training=True):
        """(train, val, test) loaders as ``bbdm_tpu/runners/base.py:359-392``
        builds them: train and val shuffled by ``seed + epoch`` (``set_epoch``),
        the test loader unshuffled; every loader drops its last partial batch.
        ``data.*.batch_size`` is per node. With ``for_training``, train and val
        go through the device cache when ``training.device_data_cache`` asks
        for it; ``test()`` passes False, as it iterates neither."""
        from bbdm_tpu_torch.data import get_dataset

        train_ds, val_ds, test_ds = get_dataset(self.config.data)
        data = self.config.data
        train = self._loader(train_ds, data.train.batch_size, data.train.get("shuffle", True))
        val = self._loader(val_ds, data.val.batch_size, data.val.get("shuffle", True))
        if for_training:
            train, val = self._device_cache("train", train), self._device_cache("val", val)
        return train, val, self._loader(test_ds, data.test.batch_size, False)

    def _device_cache(self, stage, loader):
        """``loader`` through ``data/device_cache.py`` per the config, on the
        copy of ``stage``'s set this runner already holds, else a new one that
        it keeps until :meth:`train` ends."""
        from bbdm_tpu_torch.data.device_cache import maybe_device_cache

        cached = maybe_device_cache(loader, self.config.get("training") or ConfigNode(),
                                    self.world, self.device, self.logger,
                                    resident=self._resident.get(stage))
        if cached is not loader:
            self._resident[stage] = cached.resident
        return cached

    def _to_device(self, a) -> torch.Tensor:
        """NHWC float batch -> NCHW-contiguous fp32 on the device; on the card
        through pinned memory without waiting (a pageable copy would wait for
        the queued steps). A tensor (a batch the device cache gathered) is
        already that, and passes through."""
        if isinstance(a, torch.Tensor):
            return a
        t = torch.from_numpy(np.asarray(a, np.float32))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        else:
            t = t.to(self.device)
        return t.permute(0, 3, 1, 2).contiguous()

    def _put_batch(self, batch):
        return self._to_device(batch["x"]), self._to_device(batch["x_cond"])

    @staticmethod
    def _host(a) -> np.ndarray:
        """A batch's images as NHWC float32 numpy (a gathered NCHW tensor back
        from the device)."""
        if isinstance(a, torch.Tensor):
            return a.permute(0, 2, 3, 1).float().cpu().numpy()
        return np.asarray(a)

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
        optim_states = {"optimizer": [opt_state_to_jax(self.state.optimizer, self.model,
                                                       self.fuse_threshold())],
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
        """The global batch's eval loss (every rank takes part)."""
        x, y = self._put_batch(val_batch)
        with self.full_weights():
            loss = float(self._eval_step(self.state, x, y, self.train_generator))
        if self.writer is not None:
            self.writer.add_scalar("loss/val_step", loss, step)
        return loss

    def validation_epoch(self, val_loader, epoch):
        with self.full_weights():
            losses = [float(self._eval_step(self.state, *self._put_batch(b),
                                            self.train_generator)) for b in val_loader]
        average_loss = sum(losses) / max(len(losses), 1)
        if self.writer is not None:
            self.writer.add_scalar("val_epoch/loss", average_loss, epoch)
        return average_loss

    def sample_step(self, train_batch, val_batch):
        """Sample grids with the EMA weights (``bbdm_tpu/runners/base.py:349-355``),
        on rank 0 alone, drawing what a one-rank run draws."""
        sample_path = make_dir(os.path.join(self.config.result.image_path,
                                            str(self.global_step)))
        with (swapped_in(self.state.params, self.state.ema) if self.use_ema
              else contextlib.nullcontext()), collectives.rank_local():
            self.sample(train_batch, sample_path, stage="train")
            self.sample(val_batch, sample_path, stage="val")

    def shared_dirs(self, *paths):
        """``paths`` made by each node's first rank, then a barrier: the
        directories every rank of a ``sample_to_eval`` writes into."""
        if self.world.local_rank == 0:
            for p in paths:
                make_dir(p)
        collectives.barrier()
        return paths

    # ---------------------------------------------------------------- train

    def train(self):
        """``bbdm_tpu/runners/base.py:394-682`` (see the module docstring).
        ``self.stop_reason`` says why it ended (None: ran to the end)."""
        if self.state is None:
            raise RuntimeError("train() needs a runner built for training (args.train)")
        self.logger(self.__class__.__name__)
        train_loader, val_loader, _ = self._build_loaders()
        epoch_length = len(train_loader)
        training = self.config.training
        self.logger(f"start training {self.config.model.model_name} on "
                    f"{self.config.data.dataset_name}, {epoch_length} iters per epoch")
        self.logger(f"mesh {{'data': {self.grid.data_size}, 'model': {self.grid.model_size}}}"
                    f" | model_parallel={self.model_parallel}"
                    f" | fsdp={'on (ZeRO-3 state layout)' if self.fsdp else 'off'}")
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

        profiler = _ProfileWindow(training, self.device) if self.is_main else None

        stop_reason = None
        unwinding = False
        sigterm_seen = False
        train_t0 = time.monotonic()
        max_wall = training.get("max_wall_sec", None)
        stop_file = training.get("stop_file",
                                 os.path.join(self.config.result.result_path, "STOP"))

        def poll_stop():
            """Rank 0's triggers, broadcast to every rank at each step boundary."""
            nonlocal stop_reason
            if self.is_main and stop_reason is None:
                if max_wall is not None and time.monotonic() - train_t0 > float(max_wall):
                    stop_reason = f"wall budget ({max_wall}s) exhausted"
                elif stop_file and os.path.exists(stop_file):
                    stop_reason = f"stop file {stop_file} present"
            if collectives.broadcast_flag(stop_reason is not None) and stop_reason is None:
                stop_reason = "stop broadcast from rank 0"
            return stop_reason

        def on_sigterm(signum, frame):
            nonlocal stop_reason, sigterm_seen
            if unwinding or sigterm_seen or stop_reason is not None:
                raise KeyboardInterrupt("SIGTERM")
            sigterm_seen = True
            if not self.is_main:
                print(f"rank {self.world.rank}: SIGTERM ignored for the graceful stop (rank 0 "
                      "decides; send again to force the emergency-save raise)", flush=True)
                return
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
        anomaly = torch.is_anomaly_enabled()
        torch.autograd.set_detect_anomaly(anomaly or bool(training.get("debug_nan", False)))
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
                    if profiler is not None:
                        profiler.step(self.global_step, self.logger)
                    # the previous step's loss: reading it waits for that step
                    # only, not for the one just queued
                    if pending_log is not None and self.writer is not None:
                        self.writer.add_scalar("loss/train", float(pending_log[1]["loss"]),
                                               pending_log[0])
                    pending_log = (self.global_step, metrics)
                    if self.global_step % 50 == 0:
                        self.validation_step(next_val_batch(), epoch, self.global_step)
                    if self.global_step % sample_every == 0:
                        val_batch = next_val_batch()  # every rank: the val iterators stay aligned
                        with self.full_weights():
                            if self.is_main:
                                self.sample_step(train_batch, val_batch)
                    if poll_stop():
                        break
                if pending_log is not None and self.writer is not None:
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
                    with self.full_weights():
                        if self.is_main:
                            self.logger("saving latest checkpoint...")
                            model_states, optim_states = self.get_checkpoint_states(
                                stage="graceful_stop" if stop_reason is not None
                                else "epoch_end")
                            self._save_checkpoints(epoch, model_states, optim_states,
                                                   average_loss)
                            del model_states, optim_states

                if stop_reason is not None:
                    if self.is_main and stop_file and os.path.exists(stop_file):
                        os.remove(stop_file)  # so that a resume does not stop at once
                    break
        except BaseException as e:
            unwinding = True
            with self.full_weights():
                if self.is_main:
                    self.logger("exception save model start....")
                    model_states, optim_states = self.get_checkpoint_states(stage="exception")
                    ckpt_path = self.config.result.ckpt_path
                    save_checkpoint(model_states, os.path.join(ckpt_path, "last_model.ckpt"))
                    save_checkpoint(optim_states,
                                    os.path.join(ckpt_path, "last_optim_sche.ckpt"))
                    self.logger("exception save model success!")
            print(f"rank {self.world.rank} str(e):", str(e))
            traceback.print_exc()
            raise  # a non-zero exit for the supervisor
        finally:
            self._resident.clear()
            torch.autograd.set_detect_anomaly(anomaly)
            if profiler is not None:
                profiler.close(self.global_step, self.logger)
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
            self.model.eval()
            self.stop_reason = stop_reason

    # ----------------------------------------------------------------- test

    def test(self):
        """``bbdm_tpu/runners/base.py:714-744``: every rank samples its rows of
        the test set (the node's model peers the same rows, model index 0
        writing them), or rank 0 writes the grids of its first batch."""
        _, val_loader, test_loader = self._build_loaders(for_training=False)
        if len(test_loader) == 0:
            test_loader = val_loader
        with self.full_weights():
            if self.config.args.sample_to_eval:
                self.sample_to_eval(test_loader, self.config.result.sample_to_eval_path)
            elif self.is_main:
                with collectives.rank_local():
                    for i, test_batch in enumerate(test_loader):
                        self.sample(test_batch,
                                    os.path.join(self.config.result.sample_path, str(i)),
                                    stage="test")
                        break
        collectives.barrier()


class _ProfileWindow:
    """``training.profile_dir``: a ``torch.profiler`` trace of global steps
    ``(profile_start_step, profile_start_step + profile_steps]`` (the JAX
    runner's window, ``bbdm_tpu/runners/base.py:423-427,532-539``), written to
    ``profile_dir`` as a chrome trace when the window ends or training does."""

    def __init__(self, training, device):
        self.dir = training.get("profile_dir", None)
        self.start = int(training.get("profile_start_step", 10))
        self.stop = self.start + int(training.get("profile_steps", 5))
        self.device = device
        self.prof: Optional[torch.profiler.profile] = None
        self.path = None

    def step(self, global_step, log):
        if not self.dir:
            return
        if self.prof is None and self.path is None and global_step == self.start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
        elif self.prof is not None and global_step >= self.stop:
            self.close(global_step, log)

    def close(self, global_step, log):
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir,
                                 f"steps_{self.start + 1}-{global_step}.pt.trace.json")
        prof.export_chrome_trace(self.path)
        log(f"profiler trace written to {self.path}")
