"""Config tree: the ``ConfigNode`` of ``bbdm_tpu/config.py`` without PyYAML at
import time, plus a Python-dict twin of ``configs/Template-LBBDM-f4.yaml``.

``load_config`` imports ``yaml`` when called, so the package (and
``chip_smoke.py``, which uses :func:`lbbdm_f4_config`) runs where PyYAML is
not installed.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace
from typing import Any


class ConfigNode(SimpleNamespace):
    """Nested attribute namespace with ``in``, ``get`` and ``to_dict``
    (same behaviour as ``bbdm_tpu.config.ConfigNode``)."""

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key)

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def __setitem__(self, key: str, value: Any) -> None:
        setattr(self, key, value)

    def keys(self):
        return vars(self).keys()

    def items(self):
        return vars(self).items()

    def to_dict(self) -> dict:
        return namespace2dict(self)

    def clone(self) -> "ConfigNode":
        return copy.deepcopy(self)


def dict2namespace(d: dict) -> ConfigNode:
    """Recursively convert a dict into a ConfigNode tree."""
    node = ConfigNode()
    for key, value in d.items():
        if isinstance(value, dict):
            value = dict2namespace(value)
        setattr(node, key, value)
    return node


def namespace2dict(ns) -> dict:
    """Inverse of dict2namespace."""
    out = {}
    for key, value in vars(ns).items():
        out[key] = namespace2dict(value) if isinstance(value, SimpleNamespace) else value
    return out


def load_config(path: str) -> ConfigNode:
    """Load a YAML config (``yaml.FullLoader``, so ``!!python/tuple`` parses)."""
    import yaml

    with open(path, "r") as f:
        raw = yaml.load(f, Loader=yaml.FullLoader)
    return dict2namespace(raw)


# configs/Template-LBBDM-f4.yaml as loaded by bbdm_tpu.config.load_config
# (tests/test_torch_slice.py holds the two equal).
_LBBDM_F4 = {
    "runner": "BBDMRunner",
    "training": {
        "n_epochs": 100, "n_steps": 200000, "save_interval": 2,
        "sample_interval": 2, "validation_interval": 2,
        "accumulate_grad_batches": 4,
    },
    "testing": {"clip_denoised": False, "sample_num": 5},
    "data": {
        "dataset_name": "dataset_name",
        "dataset_type": "custom_aligned",
        "dataset_config": {
            "dataset_path": "dataset_path", "image_size": 256, "channels": 3,
            "to_normal": True, "flip": False,
        },
        "train": {"batch_size": 8, "shuffle": True},
        "val": {"batch_size": 8, "shuffle": True},
        "test": {"batch_size": 8},
    },
    "model": {
        "model_name": "LBBDM-f4",
        "model_type": "LBBDM",
        "latent_before_quant_conv": False,
        "normalize_latent": False,
        "only_load_latent_mean_std": False,
        "mixed_precision": True,
        "init_scheme": "reference",
        "EMA": {"use_ema": True, "ema_decay": 0.995, "update_ema_interval": 8,
                "start_ema_step": 30000},
        "CondStageParams": {"n_stages": 2, "in_channels": 3, "out_channels": 3},
        "VQGAN": {"params": {
            "ckpt_path": "results/VQGAN/CelebAMaskHQ-f4.ckpt",
            "embed_dim": 3,
            "n_embed": 8192,
            "ddconfig": {
                "double_z": False, "z_channels": 3, "resolution": 256,
                "in_channels": 3, "out_ch": 3, "ch": 128, "ch_mult": (1, 2, 4),
                "num_res_blocks": 2, "attn_resolutions": [], "dropout": 0.0,
            },
            "lossconfig": {"target": "torch.nn.Identity"},
        }},
        "BB": {
            "optimizer": {"weight_decay": 0.0, "optimizer": "Adam", "lr": 1.0e-4,
                          "beta1": 0.9},
            "lr_scheduler": {"factor": 0.5, "patience": 3000, "threshold": 0.0001,
                             "cooldown": 3000, "min_lr": 5.0e-7},
            "params": {
                "mt_type": "linear", "objective": "grad", "loss_type": "l1",
                "skip_sample": True, "sample_type": "linear", "sample_step": 200,
                "num_timesteps": 1000, "eta": 1.0, "max_var": 1.0,
                "UNetParams": {
                    "image_size": 64, "in_channels": 3, "model_channels": 128,
                    "out_channels": 3, "num_res_blocks": 2,
                    "attention_resolutions": (32, 16, 8),
                    "channel_mult": (1, 4, 8), "conv_resample": True, "dims": 2,
                    "num_heads": 8, "num_head_channels": 64,
                    "use_scale_shift_norm": True, "resblock_updown": True,
                    "use_spatial_transformer": False, "context_dim": None,
                    "condition_key": "nocond",
                },
            },
        },
    },
}


def lbbdm_f4_config() -> ConfigNode:
    """A fresh ConfigNode of the LBBDM-f4 template."""
    return dict2namespace(copy.deepcopy(_LBBDM_F4))
