"""FID InceptionV3 (pool3, 2048-d), NCHW (port of ``bbdm_tpu/evaluation/inception.py``).

The network behind ``pytorch_fid``: torchvision's InceptionV3 with the FID
pooling (the 3x3 average pools exclude padding; Mixed_7c's pool branch is a
max-pool). Submodule names are pytorch_fid's and torchvision's
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_mean``), so
such a state dict loads through ``load_state_dict`` once
:func:`inception_state_dict` has dropped ``fc.*``, ``AuxLogits.*`` and
``num_batches_tracked``. The JAX package's parameter tree converts both ways
(:func:`state_dict_from_inception_tree`, :func:`inception_tree_from_state_dict`).

Input: [N, 3, H, W] in [0, 1], resized to 299 (bilinear, half-pixel centres, no
antialiasing: ``jax.image.resize(..., "bilinear", antialias=False)``) and
scaled to [-1, 1]. Runs in fp32 (TF32 off, see the package's ``__init__``);
convolutions and pools are cuDNN's through torch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

_BN = {"weight": "bn_scale", "bias": "bn_bias", "running_mean": "bn_mean",
       "running_var": "bn_var"}


def resize_299(x):
    """[N, C, H, W] -> [N, C, 299, 299], as ``jax.image.resize(..., "bilinear",
    antialias=False)``: half-pixel centres, two taps per axis up or down."""
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                         antialias=False)


def _avg_pool3(x):
    """3x3 stride-1 average, pad 1, over the cells inside the image only."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm: (x - running_mean) * rsqrt(running_var + 1e-3) * weight + bias."""

    def __init__(self, channels: int):
        super().__init__()
        for name, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                           ("running_var", 1.0)):
            self.register_buffer(name, torch.full((channels,), fill))

    def forward(self, x):
        c = lambda t: t.view(1, -1, 1, 1)
        return ((x - c(self.running_mean)) * torch.rsqrt(c(self.running_var) + 1e-3)
                * c(self.weight) + c(self.bias))


class BasicConv2d(nn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        self.bn = FrozenBatchNorm(out_ch)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, in_ch, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b1, b5, b3, self.branch_pool(_avg_pool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                      self.branch7x7dbl_5):
            bd = layer(bd)
        return torch.cat([b1, b7, bd, self.branch_pool(_avg_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """``pool``: "avg" (Mixed_7b, padding excluded) or "max" (Mixed_7c, the FID tweak)."""

    def __init__(self, in_ch, pool):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        pooled = _avg_pool3(x) if self.pool == "avg" else F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([b1, b3, bd, self.branch_pool(pooled)], 1)


class FIDInceptionV3(nn.Module):
    """[N, 3, H, W] in [0, 1] -> pool3 activations [N, 2048]; frozen, in eval mode."""

    def __init__(self, resize_input: bool = True, normalize_input: bool = True):
        super().__init__()
        self.resize_input, self.normalize_input = resize_input, normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.requires_grad_(False)
        self.eval()

    def forward(self, x):
        if self.resize_input:
            x = resize_299(x)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))


def inception_state_dict(sd: dict) -> dict:
    """A pytorch_fid / torchvision InceptionV3 state dict as :class:`FIDInceptionV3`
    loads it strictly: ``fc.*``, ``AuxLogits.*`` and ``num_batches_tracked`` dropped."""
    return {k: torch.as_tensor(v) for k, v in sd.items()
            if k.split(".")[0] not in ("fc", "AuxLogits")
            and not k.endswith("num_batches_tracked")}


def state_dict_from_inception_tree(tree: dict) -> dict:
    """The JAX package's FIDInceptionV3 parameter tree (HWIO ``conv.kernel``,
    ``bn_scale``/``bn_bias``/``bn_mean``/``bn_var``) -> this module's state dict."""
    names = {v: k for k, v in _BN.items()}
    out = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + [key])
            elif key == "kernel" and path[-1:] == ["conv"]:
                w = np.asarray(value, np.float32).transpose(3, 2, 0, 1)
                out[".".join(path + ["weight"])] = torch.from_numpy(w.copy())
            elif key in names:
                out[".".join(path + ["bn", names[key]])] = torch.from_numpy(
                    np.array(value, np.float32))
            else:
                raise KeyError(f"unexpected leaf {'/'.join(path + [key])} in an Inception tree")

    walk(tree, [])
    return out


def inception_tree_from_state_dict(sd: dict) -> dict:
    """A torch InceptionV3 state dict -> the JAX package's parameter tree (as
    ``bbdm_tpu.evaluation.inception.convert_inception_state_dict`` gives it)."""
    out: dict = {}
    for key, value in sd.items():
        v = value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
        parts = key.split(".")
        if parts[0] in ("fc", "AuxLogits"):
            continue
        if parts[-2] == "conv" and parts[-1] == "weight":
            path, v = parts[:-1] + ["kernel"], v.transpose(2, 3, 1, 0)
        elif parts[-2] == "bn" and parts[-1] in _BN:
            path = parts[:-2] + [_BN[parts[-1]]]
        else:
            continue  # num_batches_tracked
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(v, dtype=np.float32)
    return out
