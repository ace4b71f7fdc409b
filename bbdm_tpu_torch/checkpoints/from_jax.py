"""The JAX package's parameter tree <-> the port's ``state_dict``.

The port's module names are the flax names, so the mapping is mechanical:
``a.b.kernel`` -> ``a.b.weight`` (conv HWIO -> OIHW, dense [in, out] ->
[out, in], a 3-D ``DenseGeneral`` kernel as it is: the port keeps flax's
layout), ``a.b.scale`` (GroupNorm, LayerNorm) -> ``a.b.weight``, ``bias``,
the codebook's and ``nn.Embed``'s ``embedding`` and free parameters such as
``pos_emb`` as they are; a ``BERTEmbedder``'s ``transformer/...`` tree maps
to its ``transformer.`` entries by the same rule. A reference ``.pth`` loads as
``checkpoints/torch_import.py`` composed with this function. Latent
statistics are NHWC ``[1, 1, 1, C]`` in a checkpoint, ``[1, C, 1, 1]`` in the
port. The optimizer's moments and the plateau state convert both ways too,
and for VQGAN training the discriminator's parameters and BatchNorm
statistics (``disc_stats``) and the two players' plain ``optax.adam`` states.
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
        name = (f"{mod}.weight" if mod else "weight") if leaf in ("kernel", "scale") else key
        if name not in expected:
            raise KeyError(f"unused JAX parameter {key!r} (no port parameter {name!r})")
        out[name] = _port_array(name, arr, expected[name])
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port parameters missing from the JAX tree: {missing[:5]}"
                       f"{' ...' if len(missing) > 5 else ''}")
    return out


def _jax_path(name: str, t) -> tuple:
    """The JAX tree's key path of the port entry ``name`` (tensor ``t``)."""
    mod, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    if leaf == "weight":
        leaf = "kernel" if t.ndim > 1 else "scale"
    return (*(mod.split(".") if mod else ()), leaf)


def _jax_array(name: str, t: torch.Tensor) -> np.ndarray:
    """The port entry ``name`` in the JAX layout, fp32 numpy: a kernel's conv
    OIHW -> HWIO, dense [out, in] -> [in, out]."""
    arr = t.detach().float().cpu().numpy()
    if _jax_path(name, t)[-1] == "kernel" and arr.ndim in (2, 4):
        arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T)
    return arr


def _port_array(name: str, arr: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_jax_array` for the port entry ``name`` like ``t`` (a
    3-D ``DenseGeneral`` kernel keeps flax's layout)."""
    if _jax_path(name, t)[-1] == "kernel" and arr.ndim in (2, 4):
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
    if tuple(arr.shape) != tuple(t.shape):
        raise ValueError(f"{name!r}: shape {arr.shape} != port {tuple(t.shape)}")
    return torch.from_numpy(np.array(arr)).to(t.dtype)


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
        *mods, leaf = _jax_path(name, t)
        node = tree
        for part in mods:
            node = node.setdefault(part, {})
        node[leaf] = {} if name in masked else _jax_array(name, t)
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

# Under ``training.fuse_small_leaves`` (``bbdm_tpu/training/bucket.py``) each
# moment is {"bucket": vec, "big": {str(i): leaf}}: ``i`` counts every leaf of
# the parameter tree in its flatten order (sorted keys at every level); the
# trainable leaves of at most ``training.fuse_threshold`` elements are
# flattened in the JAX layout and concatenated in that order as fp32 into
# ``vec``, and every other leaf stays under "big" ({} where it is frozen).


class LeafBucket:
    """``SmallLeafBucketer``'s layout over ``model``'s entries: ``small`` the
    bucketed names in order, ``big`` {flatten index: name} of the rest."""

    def __init__(self, model: nn.Module, trainable, threshold: int = 65536):
        sd = model.state_dict()
        order = sorted(sd, key=lambda n: _jax_path(n, sd[n]))
        trainable = set(trainable)
        self.small = [n for n in order if n in trainable and sd[n].numel() <= threshold]
        small = set(self.small)
        self.big = {str(i): n for i, n in enumerate(order) if n not in small}
        self.total = sum(sd[n].numel() for n in self.small)
        self.jax_shapes = {n: _jax_array(n, torch.empty(sd[n].shape)).shape
                           for n in self.small}

    def to_jax(self, tensors: dict) -> dict:
        """{name: port tensor} of the trainable entries -> one bucketed moment."""
        vec = [_jax_array(n, tensors[n]).ravel() for n in self.small]
        return {"bucket": np.concatenate(vec) if vec else np.zeros(0, np.float32),
                "big": {i: _jax_array(n, tensors[n]) if n in tensors else {}
                        for i, n in self.big.items()}}

    def from_jax(self, moment, expected: dict) -> dict:
        """One bucketed moment -> {name: tensor} for the ``expected``
        (trainable) entries; raises where the moment does not fit."""
        vec = np.asarray(moment["bucket"], np.float32)
        if vec.shape != (self.total,):
            raise ValueError(f"a bucket of {vec.shape} where this model's is ({self.total},)")
        if sorted(moment["big"]) != sorted(self.big):
            raise ValueError("the bucketed state's 'big' leaves are not this model's")
        out, at = {}, 0
        for n in self.small:
            t = expected[n]
            out[n] = _port_array(n, vec[at:at + t.numel()].reshape(self.jax_shapes[n]), t)
            at += t.numel()
        for i, n in self.big.items():
            if n in expected:
                out[n] = _port_array(n, np.asarray(moment["big"][i]), expected[n])
            elif not isinstance(moment["big"][i], Mapping) or moment["big"][i]:
                raise ValueError(f"the frozen entry {n!r} holds optimizer state")
        return out


def opt_state_to_jax(optimizer, model: nn.Module, fuse_threshold=None) -> dict:
    """The optimizer's state as the JAX package's ``opt_state`` tree for
    ``model``; bucketed when ``fuse_threshold`` is set (the JAX runner's
    layout under ``training.fuse_small_leaves``)."""
    sd = model.state_dict()
    if fuse_threshold is not None:
        bucket = LeafBucket(model, optimizer.names, fuse_threshold)

        def tree(tensors):
            return bucket.to_jax(dict(zip(optimizer.names, tensors)))
    else:
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


def opt_state_from_jax(tree, optimizer, model: nn.Module = None, fuse_threshold=None) -> None:
    """Load a JAX ``opt_state`` tree into ``optimizer`` (in place): the
    bucketed layout over ``model`` when ``fuse_threshold`` is set, else the
    per-leaf one. Raises ValueError where the tree does not fit: another
    optimizer or weight-decay setting, the other ``fuse_small_leaves``
    layout, another bucket."""
    expected = dict(zip(optimizer.names, optimizer.params))
    try:
        node = tree["inner_state"]
        if optimizer.name != "SGD":
            node = node["1" if optimizer.weight_decay else "0"]
        moments = {k: node[k] for k in _MOMENTS[optimizer.name]}
        bucketed = [isinstance(m, Mapping) and "bucket" in m for m in moments.values()]
        if any(bucketed) != (fuse_threshold is not None):
            raise ValueError(
                "it was written with training.fuse_small_leaves "
                f"{'on' if any(bucketed) else 'off'}: resume with the same setting")
        if fuse_threshold is not None:
            bucket = LeafBucket(model, optimizer.names, fuse_threshold)
            loaded = {k: bucket.from_jax(m, expected) for k, m in moments.items()}
        else:
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


# ------------------------------------------------------------- VQGAN training
# A VQGAN model checkpoint holds {"model": {"vqgan", "discriminator",
# "disc_stats"}, "step", "epoch"} and its optimizer file {"optimizer":
# [gen_opt, disc_opt], "scheduler": []} (bbdm_tpu/runners/vqgan.py:143-168),
# each opt state flax's to_state_dict of optax.adam's (ScaleByAdamState,
# EmptyState): {"0": {"count", "mu", "nu"}, "1": {}}.

def module_trees_to_jax(module: nn.Module) -> tuple:
    """(parameter tree, buffer tree or None) of ``module``: for the
    discriminator its params and its ``batch_stats`` (None under ActNorm)."""
    buffers = dict(module.named_buffers())
    return (jax_tree_from_state_dict(dict(module.named_parameters())),
            jax_tree_from_state_dict(buffers) if buffers else None)


@torch.no_grad()
def load_module_trees(module: nn.Module, params, buffers=None) -> None:
    """Inverse of :func:`module_trees_to_jax`, in place; ``buffers`` None
    leaves the module's buffers as they are."""
    for named, tree in ((dict(module.named_parameters()), params),
                        (dict(module.named_buffers()), buffers)):
        if tree is None or not named:
            continue
        for k, t in state_dict_from_jax(tree, named).items():
            named[k].copy_(t)


def adam_state_to_jax(optimizer) -> dict:
    """An Adam :class:`~bbdm_tpu_torch.training.optim.Optimizer` as the state of
    ``optax.adam`` over the tree its parameter names make."""
    def tree(tensors):
        return jax_tree_from_state_dict(dict(zip(optimizer.names, tensors)))

    return {"0": {"count": optimizer.state["count"].cpu().numpy(),
                  "mu": tree(optimizer.state["mu"]), "nu": tree(optimizer.state["nu"])},
            "1": {}}


def adam_state_from_jax(tree, optimizer) -> None:
    """Load an ``optax.adam`` state tree into an Adam ``optimizer`` (in place).
    Raises ValueError where it does not fit its parameters."""
    expected = dict(zip(optimizer.names, optimizer.params))
    try:
        node = tree["0"]
        loaded = {k: state_dict_from_jax(node[k], expected) for k in ("mu", "nu")}
        count = int(np.asarray(node["count"]))
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"the optimizer state does not fit an optax.adam state over "
                         f"these parameters: {e}") from e
    with torch.no_grad():
        for k, sd in loaded.items():
            for name, t in zip(optimizer.names, optimizer.state[k]):
                t.copy_(sd[name])
    optimizer.state["count"].fill_(count)
