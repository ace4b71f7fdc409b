"""The JAX package's parameter tree <-> the port's ``state_dict``.

The port's module names are the flax names, so the mapping is mechanical:
``a.b.kernel`` -> ``a.b.weight`` (conv HWIO -> OIHW, dense [in, out] ->
[out, in]), ``a.b.scale`` (GroupNorm) -> ``a.b.weight``, ``bias`` and the
codebook ``embedding`` as they are. A reference ``.pth`` loads as
``checkpoints/torch_import.py`` composed with this function. Latent
statistics are NHWC ``[1, 1, 1, C]`` in a checkpoint, ``[1, C, 1, 1]`` in the
port. The optimizer's moments and the plateau state convert both ways too.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from bbdm_tpu_torch.training.plateau import PlateauState


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def state_dict_from_jax(params, model) -> dict:
    """Convert a (nested dict of numpy arrays) JAX parameter tree for ``model``
    (a module, or a {name: tensor} dict of the entries it must give, e.g. the
    trainable ones for an optimizer moment whose frozen leaves are ``{}``).

    Raises KeyError on a JAX leaf the model has no place for, or a model
    parameter the tree does not give; ValueError on a shape mismatch.
    """
    expected = model if isinstance(model, Mapping) else model.state_dict()
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


def jax_tree_from_state_dict(state, *, masked=()) -> dict:
    """Inverse of :func:`state_dict_from_jax`: a ``state_dict`` (or a module)
    -> the JAX package's nested parameter tree of float32 numpy arrays. Names
    in ``masked`` become ``{}``, the serialised form of a leaf that
    ``optax.masked`` leaves without state."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    masked = set(masked)
    tree: dict = {}
    for name, t in state.items():
        mod, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if leaf == "weight":
            leaf = "kernel" if t.ndim in (2, 4) else "scale"
        node = tree
        for part in mod.split(".") if mod else ():
            node = node.setdefault(part, {})
        if name in masked:
            node[leaf] = {}
            continue
        arr = t.detach().float().cpu().numpy()
        if leaf == "kernel":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
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


# ------------------------------------------------------- optimizer and plateau
# An optimizer checkpoint holds ``{"optimizer": [opt_state], "scheduler":
# [plateau]}`` (bbdm_tpu/runners/base.py:246-249), opt_state being flax's
# ``to_state_dict`` of ``optax.masked(chain)``: {"inner_state": {"0": {"count",
# "mu", "nu"}}} for Adam, {"inner_state": {"0": {"nu"}}} for RMSProp (the
# state moves to "1" behind add_decayed_weights's empty "0" when weight_decay
# is set) and {"inner_state": {"trace"}} for SGD; moments are parameter trees
# with {} at the masked (frozen VQGAN) leaves.

_MOMENTS = {"Adam": ("mu", "nu"), "RMSProp": ("nu",), "SGD": ("trace",)}


def opt_state_to_jax(optimizer, model: nn.Module) -> dict:
    """The optimizer's state as the JAX package's ``opt_state`` tree for ``model``."""
    sd = model.state_dict()
    masked = [k for k in sd if k not in set(optimizer.names)]

    def tree(tensors):
        return jax_tree_from_state_dict({**sd, **dict(zip(optimizer.names, tensors))},
                                        masked=masked)

    node = {k: tree(optimizer.state[k]) for k in _MOMENTS[optimizer.name]}
    if optimizer.name == "SGD":
        return {"inner_state": node}
    if "count" in optimizer.state:
        node["count"] = optimizer.state["count"].cpu().numpy()
    return {"inner_state": {"0": {}, "1": node} if optimizer.weight_decay else {"0": node}}


def opt_state_from_jax(tree, optimizer) -> None:
    """Load a JAX ``opt_state`` tree into ``optimizer`` (in place). Raises
    ValueError where the tree does not fit: another optimizer or weight-decay
    setting, or the bucketed layout of ``training.fuse_small_leaves``."""
    expected = dict(zip(optimizer.names, optimizer.params))
    try:
        node = tree["inner_state"]
        if optimizer.name != "SGD":
            node = node["1" if optimizer.weight_decay else "0"]
        moments = {k: node[k] for k in _MOMENTS[optimizer.name]}
        if any("bucket" in m for m in moments.values()):
            raise ValueError("it was written with training.fuse_small_leaves, whose bucketed "
                             "layout the port does not read")
        loaded = {k: state_dict_from_jax(m, expected) for k, m in moments.items()}
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"the optimizer state does not fit a {optimizer.name} state over the "
                         f"trainable parameters: {e}") from e
    with torch.no_grad():
        for k, sd in loaded.items():
            for name, t in zip(optimizer.names, optimizer.state[k]):
                t.copy_(sd[name])
    if "count" in optimizer.state:
        optimizer.state["count"].fill_(int(np.asarray(node["count"])))


def plateau_to_jax(state) -> dict:
    """A PlateauState as the JAX ``scheduler`` entry: 0-d fp32 lr and best, int32 counters."""
    return {k: getattr(state, k).cpu().numpy() for k in ("lr", "best", "num_bad",
                                                         "cooldown_count")}


def plateau_from_jax(d, device=None) -> PlateauState:
    """Inverse of :func:`plateau_to_jax`."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return PlateauState(lr=torch.tensor(float(d["lr"]), **f32),
                        best=torch.tensor(float(d["best"]), **f32),
                        num_bad=torch.tensor(int(d["num_bad"]), **i32),
                        cooldown_count=torch.tensor(int(d["cooldown_count"]), **i32))
