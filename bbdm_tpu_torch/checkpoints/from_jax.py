"""The JAX package's parameter tree <-> the port's ``state_dict``.

The port's module names are the flax names, so the mapping is mechanical:
``a.b.kernel`` -> ``a.b.weight`` (conv HWIO -> OIHW, dense [in, out] ->
[out, in]), ``a.b.scale`` (GroupNorm) -> ``a.b.weight``, ``bias`` and the
codebook ``embedding`` as they are. A reference ``.pth`` loads as
``checkpoints/torch_import.py`` composed with this function. Latent
statistics are NHWC ``[1, 1, 1, C]`` in a checkpoint, ``[1, C, 1, 1]`` in the
port.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def state_dict_from_jax(params, model: nn.Module) -> dict:
    """Convert a (nested dict of numpy arrays) JAX parameter tree for ``model``.

    Raises KeyError on a JAX leaf the model has no place for, or a model
    parameter the tree does not give; ValueError on a shape mismatch.
    """
    expected = model.state_dict()
    out = {}
    for key, arr in _flatten(params):
        mod, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        if leaf == "kernel":
            name = f"{mod}.weight"
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
        elif leaf == "scale":
            name = f"{mod}.weight"
        else:
            name = key
        if name not in expected:
            raise KeyError(f"unused JAX parameter {key!r} (no port parameter {name!r})")
        if tuple(arr.shape) != tuple(expected[name].shape):
            raise ValueError(f"{key!r}: shape {arr.shape} != port {tuple(expected[name].shape)}")
        out[name] = torch.from_numpy(np.array(arr)).to(expected[name].dtype)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port parameters missing from the JAX tree: {missing[:5]}"
                       f"{' ...' if len(missing) > 5 else ''}")
    return out


def jax_tree_from_state_dict(state) -> dict:
    """Inverse of :func:`state_dict_from_jax`: a ``state_dict`` (or a module)
    -> the JAX package's nested parameter tree of float32 numpy arrays."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    tree: dict = {}
    for name, t in state.items():
        arr = t.detach().float().cpu().numpy()
        mod, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if leaf == "weight":
            if arr.ndim == 4:
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                leaf, arr = "kernel", arr.T
            else:
                leaf = "scale"
        node = tree
        for part in mod.split(".") if mod else ():
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


LATENT_STATS = ("ori_latent_mean", "ori_latent_std", "cond_latent_mean", "cond_latent_std")


def latent_stats_from_jax(states, device=None) -> dict:
    """A checkpoint's NHWC [1, 1, 1, C] latent statistics -> [1, C, 1, 1] tensors."""
    return {k: torch.from_numpy(np.asarray(states[k], np.float32).transpose(0, 3, 1, 2).copy())
            .to(device) for k in LATENT_STATS}


def latent_stats_to_jax(stats) -> dict:
    """Inverse of :func:`latent_stats_from_jax`."""
    return {k: np.ascontiguousarray(stats[k].detach().float().cpu().numpy().transpose(0, 2, 3, 1))
            for k in LATENT_STATS}


def load_model_checkpoint(states, model: nn.Module, use_ema: bool) -> tuple:
    """Load a model checkpoint's weights into ``model``: its ``ema`` tree when
    ``use_ema`` holds and the file has one, else its ``model`` tree (the choice
    of ``bbdm_tpu/runners/base.py:252-268`` for sampling). Returns
    ``(epoch, step)``."""
    tree = states["ema"] if use_ema and "ema" in states else states["model"]
    model.load_state_dict(state_dict_from_jax(tree, model))
    return int(states["epoch"]), int(states["step"])
