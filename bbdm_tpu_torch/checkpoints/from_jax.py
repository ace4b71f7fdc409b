"""The JAX package's parameter tree -> the port's ``state_dict``.

The port's module names are the flax names, so the mapping is mechanical:
``a.b.kernel`` -> ``a.b.weight`` (conv HWIO -> OIHW, dense [in, out] ->
[out, in]), ``a.b.scale`` (GroupNorm) -> ``a.b.weight``, ``bias`` and the
codebook ``embedding`` as they are. A reference ``.pth`` loads as
``bbdm_tpu.checkpoints.torch_import.convert_*`` composed with this function.
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
