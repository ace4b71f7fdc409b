"""BaseRunner: the test half of ``bbdm_tpu/runners/base.py``.

``__init__`` builds the result tree and writes ``checkpoint/config.yaml``
(when the config carries CLI ``args``), builds the model on the device, and
loads ``model.model_load_path`` (model or EMA weights, epoch, step);
:meth:`test` runs ``sample_to_eval`` over the test set (the val set when the
test set has no full batch) or the single-batch grids. Training is not
ported: :meth:`train` raises.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod

import torch

from bbdm_tpu_torch.config import ConfigNode, device_from_gpu_ids, save_config
from bbdm_tpu_torch.models.factory import resolve_device
from bbdm_tpu_torch.runners.utils import make_save_dirs

# sampling draws come from their own stream (bbdm_tpu/runners/base.py:165-174
# folds this constant into the seed), apart from the weight-init stream
_SAMPLE_STREAM = 0x5A4D50


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
        self.global_epoch, self.global_step = 0, 0
        if args is not None:
            result = config.result = ConfigNode()
            (result.result_path, result.image_path, result.ckpt_path, result.log_path,
             result.sample_path, result.sample_to_eval_path) = make_save_dirs(
                args, prefix=config.data.dataset_name, suffix=config.model.model_name)
            self.logger("save training results to " + result.result_path)
            save_config(config, os.path.join(result.ckpt_path, "config.yaml"))
        self.use_ema = config.model.EMA.use_ema if "EMA" in config.model else False
        self.model = self.initialize_model(
            config, torch.Generator(self.device).manual_seed(self.seed))
        self.generator = torch.Generator(self.device).manual_seed(
            (_SAMPLE_STREAM << 32) + (self.seed & 0xFFFFFFFF))
        self.load_model_from_checkpoint()

    def logger(self, msg):
        print(msg, flush=True)

    @abstractmethod
    def initialize_model(self, config, generator: torch.Generator):
        """The model on ``self.device``, random weights drawn from ``generator``."""

    @abstractmethod
    def load_model_from_checkpoint(self):
        """Load ``config.model.model_load_path`` when it is set."""

    @abstractmethod
    def sample(self, batch, sample_path, stage="train"):
        """Sample one batch to PNG grids."""

    @abstractmethod
    def sample_to_eval(self, test_loader, sample_path):
        """Sweep the test set for offline metric evaluation."""

    def _build_loaders(self):
        """(val, test) loaders as ``bbdm_tpu/runners/base.py:359-377`` builds them
        (the test loader unshuffled, dropping its last partial batch)."""
        from bbdm_tpu_torch.data import DataLoader, get_dataset

        _, val_ds, test_ds = get_dataset(self.config.data)
        data, seed = self.config.data, self.config.args.seed
        val_loader = DataLoader(val_ds, data.val.batch_size,
                                shuffle=data.val.get("shuffle", True), seed=seed)
        test_loader = DataLoader(test_ds, data.test.batch_size, shuffle=False, seed=seed)
        return val_loader, test_loader

    def train(self):
        raise NotImplementedError(
            "training is not ported to the PyTorch package yet (ROADMAP.md §1 item 4); "
            "train with main.py, then sample here with --resume_model")

    def test(self):
        """``bbdm_tpu/runners/base.py:714-744`` on one process."""
        val_loader, test_loader = self._build_loaders()
        if len(test_loader) == 0:
            test_loader = val_loader
        if self.config.args.sample_to_eval:
            self.sample_to_eval(test_loader, self.config.result.sample_to_eval_path)
            return
        for i, test_batch in enumerate(test_loader):
            self.sample(test_batch, os.path.join(self.config.result.sample_path, str(i)),
                        stage="test")
            break
