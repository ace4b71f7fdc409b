"""LPIPS perceptual distance, AlexNet or VGG16 (port of ``bbdm_tpu/evaluation/lpips.py``).

lpips v0.1: images in [-1, 1] -> per-channel shift and scale -> backbone
feature taps -> each tap normalised over channels (eps outside the sqrt) ->
squared difference -> 1x1 head -> spatial mean -> sum over taps, one distance
per image pair.

:class:`LPIPS` carries lpips's state-dict names (``net.slice{k}.{idx}.weight``
at the torchvision feature index, ``lin{k}.model.1.weight``, the ``shift`` and
``scale`` buffers), so ``lpips.LPIPS(net=...).state_dict()`` and taming's
perceptual loss load through :func:`lpips_state_dict`; the JAX package's tree
converts both ways. Weights: ``weights_path`` or ``$BBDM_LPIPS_WEIGHTS``. The
module is frozen and has no dropout: VQGAN training differentiates through it
to its second input only.

The directory protocols (``calc_LPIPS``, ``random_LPIPS``,
``find_max_min_LPIPS``) follow the reference's; the networks run on the CUDA
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch
import torch.nn as nn

from bbdm_tpu_torch.evaluation.fid import IMAGE_EXTENSIONS, to_device
from bbdm_tpu_torch.models.factory import resolve_device
from bbdm_tpu_torch.utils.images import read_png, to_rgb

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# torchvision feature index -> conv (in, out, kernel, stride, pad), "pool" or
# "relu"; the lpips slices over those indices, one tap at the end of each
_ALEX = {0: (3, 64, 11, 4, 2), 1: "relu", 2: "pool", 3: (64, 192, 5, 1, 2), 4: "relu",
         5: "pool", 6: (192, 384, 3, 1, 1), 7: "relu", 8: (384, 256, 3, 1, 1), 9: "relu",
         10: (256, 256, 3, 1, 1), 11: "relu"}
_VGG_CONVS = {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128), 10: (128, 256),
              12: (256, 256), 14: (256, 256), 17: (256, 512), 19: (512, 512),
              21: (512, 512), 24: (512, 512), 26: (512, 512), 28: (512, 512)}
_VGG = {i: (*_VGG_CONVS[i], 3, 1, 1) if i in _VGG_CONVS else
        "pool" if i in (4, 9, 16, 23) else "relu" for i in range(30)}
_NETS = {"alex": (_ALEX, [(0, 2), (2, 5), (5, 8), (8, 10), (10, 12)], 3),
         "vgg": (_VGG, [(0, 4), (4, 9), (9, 16), (16, 23), (23, 30)], 2)}


def _slice_of(net: str, idx: int) -> int:
    return next(k for k, (lo, hi) in enumerate(_NETS[net][1]) if lo <= idx < hi) + 1


class _Backbone(nn.Module):
    """``slice1`` .. ``slice5``, each a Sequential named by the torchvision
    feature index; returns the five taps."""

    def __init__(self, net: str):
        super().__init__()
        layers, slices, pool = _NETS[net]
        for k, (lo, hi) in enumerate(slices):
            seq = nn.Sequential()
            for idx in range(lo, hi):
                spec = layers[idx]
                seq.add_module(str(idx), nn.ReLU(inplace=True) if spec == "relu" else
                               nn.MaxPool2d(pool, stride=2) if spec == "pool" else
                               nn.Conv2d(spec[0], spec[1], spec[2], stride=spec[3],
                                         padding=spec[4]))
            setattr(self, f"slice{k + 1}", seq)

    def forward(self, x):
        taps = []
        for k in range(5):
            x = getattr(self, f"slice{k + 1}")(x)
            taps.append(x)
        return taps


class _Head(nn.Module):
    """lpips's ``NetLinLayer`` without its dropout: ``model.1`` is the 1x1 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


def _normalize(f):
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + 1e-10)


class LPIPS(nn.Module):
    """``forward(img0, img1)``: [N, 3, H, W] pairs in [-1, 1] -> distances [N]."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        if net not in _NETS:
            raise ValueError(f"LPIPS net {net!r}: 'alex' or 'vgg'")
        self.net_name = net
        self.net = _Backbone(net)
        layers, slices, _ = _NETS[net]
        for k, (lo, hi) in enumerate(slices):
            last = max(i for i in range(lo, hi) if isinstance(layers[i], tuple))
            setattr(self, f"lin{k}", _Head(layers[last][1]))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1).clone())
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1).clone())
        self.requires_grad_(False)
        self.eval()

    def forward(self, img0, img1):
        f0 = self.net((img0 - self.shift) / self.scale)
        f1 = self.net((img1 - self.shift) / self.scale)
        total = 0.0
        for k, (a, b) in enumerate(zip(f0, f1)):
            diff = (_normalize(a) - _normalize(b)) ** 2
            total = total + getattr(self, f"lin{k}")(diff).mean(dim=(2, 3))
        return total.flatten()


def lpips_state_dict(sd: dict) -> dict:
    """An ``lpips.LPIPS`` (or taming ``LPIPS``) state dict as :class:`LPIPS` loads it
    strictly: ``scaling_layer.{shift,scale}`` renamed (the lpips constants where
    absent), the ``lins.{k}`` aliases of ``lin{k}`` dropped."""
    out = {}
    for key, value in sd.items():
        if key.startswith("lins."):
            continue
        out[key.removeprefix("scaling_layer.")] = torch.as_tensor(value)
    out.setdefault("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1).clone())
    out.setdefault("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1).clone())
    return out


def state_dict_from_lpips_tree(tree: dict, net: str) -> dict:
    """The JAX package's LPIPS tree (``conv_{idx}`` HWIO kernels and biases,
    ``lin_{k}`` [C, 1] kernels) -> the state dict of ``LPIPS(net)``."""
    out = {}
    for name, node in tree.items():
        if name.startswith("conv_"):
            idx = int(name[5:])
            prefix = f"net.slice{_slice_of(net, idx)}.{idx}"
            w = np.asarray(node["kernel"], np.float32).transpose(3, 2, 0, 1)
            out[f"{prefix}.weight"] = torch.from_numpy(w.copy())
            out[f"{prefix}.bias"] = torch.from_numpy(np.array(node["bias"], np.float32))
        elif name.startswith("lin_"):
            w = np.asarray(node["kernel"], np.float32).T[:, :, None, None]
            out[f"lin{int(name[4:])}.model.1.weight"] = torch.from_numpy(w.copy())
        else:
            raise KeyError(f"unexpected entry {name!r} in an LPIPS tree")
    return lpips_state_dict(out)


def lpips_tree_from_state_dict(sd: dict) -> dict:
    """An lpips state dict -> the JAX package's tree (as
    ``bbdm_tpu.evaluation.lpips.convert_lpips_state_dict`` gives it)."""
    out: dict = {}
    for key, value in sd.items():
        v = value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
        parts = key.split(".")
        if parts[0].startswith("lin") and parts[0][3:].isdigit():
            out[f"lin_{int(parts[0][3:])}"] = {"kernel": v[:, :, 0, 0].T.astype(np.float32)}
        elif parts[0] == "net" and parts[-1] in ("weight", "bias"):
            node = out.setdefault(f"conv_{int(parts[2])}", {})
            if parts[-1] == "weight":
                node["kernel"] = v.transpose(2, 3, 1, 0).astype(np.float32)
            else:
                node["bias"] = v.astype(np.float32)
    return out


def load_lpips_params(weights_path: str | None = None, net: str = "alex") -> dict:
    """The state dict of ``LPIPS(net)`` from ``weights_path`` or ``$BBDM_LPIPS_WEIGHTS``:
    a torch ``.pth``/``.pt`` or the JAX package's tree (``.ckpt``/``.msgpack``)."""
    path = weights_path or os.environ.get("BBDM_LPIPS_WEIGHTS")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "LPIPS weights not found. Save `lpips.LPIPS(net='alex').state_dict()` "
            "to a .pth and point BBDM_LPIPS_WEIGHTS at it (no network egress "
            "here, so the backbone cannot be auto-downloaded)."
        )
    if path.endswith((".pth", ".pt")):
        return lpips_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    from bbdm_tpu_torch.checkpoints.io import load_checkpoint

    return state_dict_from_lpips_tree(load_checkpoint(path), net)


def load_lpips(weights_path: str | None = None, net: str = "alex", device=None) -> LPIPS:
    """``LPIPS(net)`` with those weights on ``device`` (default the CUDA card,
    which raises where there is none)."""
    device = resolve_device(device)
    model = LPIPS(net)
    model.load_state_dict(load_lpips_params(weights_path, net))
    return model.to(device)


def _decode(path: str) -> np.ndarray:
    img = to_rgb(read_png(path)).astype(np.float32) / 255.0
    return img * 2.0 - 1.0


def _decode_many(paths, threads: int = 8) -> np.ndarray:
    from concurrent.futures import ThreadPoolExecutor

    if len(paths) == 1:
        return np.stack([_decode(paths[0])])
    with ThreadPoolExecutor(max_workers=min(threads, len(paths))) as ex:
        return np.stack(list(ex.map(_decode, paths)))


def batched_distances(model: LPIPS, pairs, batch_size: int = 32) -> np.ndarray:
    """LPIPS over a list of (path_a, path_b) pairs -> float32 [len(pairs)], one
    network call per ``batch_size`` pairs on the model's device; the next batch
    decodes while the card works (nothing waits for it until the end)."""
    device = model.shift.device
    out = []
    with torch.inference_mode():
        for i in range(0, len(pairs), batch_size):
            chunk = pairs[i:i + batch_size]
            a = to_device(_decode_many([p[0] for p in chunk]), device)
            b = to_device(_decode_many([p[1] for p in chunk]), device)
            out.append(model(a, b))
        return torch.cat(out).cpu().numpy()


def _sample_tree_pairs(data_dir: str, gt_dir: str, num_samples: int):
    """The reference's numeric tree: gt/<i>.png vs data/<i>/output_<j>.png
    (or flat data/<i>.png when num_samples == 1)."""
    total = len(os.listdir(data_dir))
    pairs = []
    for i in range(total):
        gt = os.path.join(gt_dir, f"{i}.png")
        for j in range(num_samples):
            if num_samples == 1:
                p = os.path.join(data_dir, f"{i}.png")
            else:
                p = os.path.join(data_dir, str(i), f"output_{j}.png")
            pairs.append((gt, p))
    return total, pairs


def calc_LPIPS(data_dir: str, gt_dir: str, num_samples: int = 1, *,
               weights_path: str | None = None, net: str = "alex",
               batch_size: int = 32, device=None) -> float:
    """reference `evaluation/LPIPS.py:11-32` directory protocol."""
    model = load_lpips(weights_path, net, device)
    total, pairs = _sample_tree_pairs(data_dir, gt_dir, num_samples)
    avg = float(batched_distances(model, pairs, batch_size).mean())
    print(data_dir)
    print(f"lpips_distance: {avg}")
    return avg


def paired_LPIPS(data_dir: str, gt_dir: str, *, weights_path: str | None = None,
                 net: str = "alex", batch_size: int = 32, device=None) -> float:
    """Mean LPIPS over the image files present (by name) in both flat directories
    (what ``sample_to_eval`` writes: dataset-stem names)."""
    model = load_lpips(weights_path, net, device)
    names = sorted(set(os.listdir(data_dir)) & set(os.listdir(gt_dir)))
    names = [n for n in names if os.path.splitext(n)[1].lower() in IMAGE_EXTENSIONS]
    if not names:
        raise ValueError(f"no common image names in {data_dir} / {gt_dir}")
    pairs = [(os.path.join(gt_dir, n), os.path.join(data_dir, n)) for n in names]
    return float(batched_distances(model, pairs, batch_size).mean())


def _distance_matrix(data_dir: str, gt_dir: str, num_samples: int, model: LPIPS,
                     batch_size: int = 32) -> np.ndarray:
    total, pairs = _sample_tree_pairs(data_dir, gt_dir, num_samples)
    return batched_distances(model, pairs, batch_size).reshape(total, num_samples)


def random_LPIPS(data_dir: str, gt_dir: str, num_samples: int = 1, *,
                 model: LPIPS | None = None, dists=None) -> float:
    """reference `:40-55`: one random output per input, drawn with the
    module-level ``random.randint`` (``random.seed`` repeats the JAX package's
    draws). ``dists``: a precomputed [total, num_samples] matrix."""
    if dists is None:
        dists = _distance_matrix(data_dir, gt_dir, num_samples, model)
    total = dists.shape[0]
    acc = 0.0
    for i in range(total):
        acc += float(dists[i, random.randint(0, num_samples - 1)])
    return acc / total


def find_max_min_LPIPS(data_dir: str, gt_dir: str, num_samples: int = 1, *,
                       weights_path: str | None = None, net: str = "alex", device=None):
    """reference `:59-72`: spread over 100 random draws."""
    model = load_lpips(weights_path, net, device)
    dists = _distance_matrix(data_dir, gt_dir, num_samples, model)
    max_l, min_l = 0.0, 10.0
    for i in range(100):
        avg = random_LPIPS(data_dir, gt_dir, num_samples, dists=dists)
        max_l, min_l = max(max_l, avg), min(min_l, avg)
        if i % 20 == 0:
            print(f"{i} current_LPIPS = {avg}, max_LPIPS = {max_l}, min_LPIPS = {min_l}")
    print(data_dir)
    print(f"max_LPIPS = {max_l}, min_LPIPS = {min_l}")
    return max_l, min_l
