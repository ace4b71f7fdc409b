"""UNet building blocks, NCHW (port of the BBDM subset of ``bbdm_tpu/models/layers.py``).

Parameters are fp32; each conv/dense casts its input, weight and bias to its
compute ``dtype`` at use, as flax does (``dtype=None``: the promotion of the
input's and the weight's dtype). GroupNorm statistics and the attention
softmax stay fp32. Attribute names are the flax module names, so
``checkpoints/from_jax.py`` is a rename plus transpose.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from bbdm_tpu_torch.ops import attention as attn_ops
from bbdm_tpu_torch.ops import group_norm as gn_ops
from bbdm_tpu_torch.ops import upsample_conv as up_ops


# ---------------------------------------------------------------- initialisers
# Each takes (tensor, generator) and fills the tensor in place; they mirror the
# flax initialisers of bbdm_tpu/models/layers.py.

def normal_init(t, g):
    """N(0, 0.02): the reference's weights_init for Conv2d/Linear."""
    t.normal_(0.0, 0.02, generator=g)


def torch_default_init(t, g):
    """U(+-1/sqrt(fan_in)): torch's default conv/linear weight init."""
    bound = 1.0 / math.sqrt(t[0].numel())
    t.uniform_(-bound, bound, generator=g)


def zeros_init(t, g):
    t.zero_()


def head_init(scheme: str):
    """Init of output-projection convs: 'reference' N(0,0.02), 'zero_heads' zeros."""
    if scheme == "reference":
        return normal_init
    if scheme == "zero_heads":
        return zeros_init
    raise ValueError(f"unknown init_scheme {scheme!r}")


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of ``module`` from its layer's initialiser."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, _Init):
                m.init_from(generator)


@contextlib.contextmanager
def eval_mode(module: nn.Module):
    """``module`` in eval mode for the block, its earlier mode restored after it."""
    was_training = module.training
    module.eval()
    try:
        yield
    finally:
        module.train(was_training)


class _Init(nn.Module):
    """A layer that owns parameters and knows their initialisers."""

    def init_from(self, g):
        raise NotImplementedError


def _dt(dtype, x, w):
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, cos first: [cos(t f), sin(t f)], f = exp(-log(P) i / half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(_Init):
    """GroupNorm(32) with fp32 statistics, optional fused SiLU / FiLM."""

    def __init__(self, channels, num_groups=32, eps=1e-5, *, device=None):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))

    def init_from(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x, *, act=None, film_scale=None, film_shift=None):
        return gn_ops.group_norm(x, self.weight, self.bias, num_groups=self.num_groups,
                                 eps=self.eps, act=act, film_scale=film_scale,
                                 film_shift=film_shift)


class Conv2d(_Init):
    """flax ``nn.Conv`` semantics: compute in ``dtype``, symmetric ``padding``,
    ``bias=False`` for ``use_bias=False``."""

    def __init__(self, in_ch, out_ch, kernel, *, stride=1, padding=0, init=normal_init,
                 dtype=None, bias=True, device=None):
        super().__init__()
        self.stride, self.padding, self.dtype, self._init = stride, padding, dtype, init
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device)) if bias else None

    def init_from(self, g):
        self._init(self.weight, g)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        dt = _dt(self.dtype, x, self.weight)
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, stride=self.stride,
                        padding=self.padding)


def conv3x3(in_ch, out_ch, *, init=normal_init, dtype=None, stride=1, device=None):
    return Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, init=init, dtype=dtype,
                  device=device)


def conv1x1(in_ch, out_ch, *, init=normal_init, dtype=None, bias=True, device=None):
    return Conv2d(in_ch, out_ch, 1, init=init, dtype=dtype, bias=bias, device=device)


class Dense(_Init):
    """flax ``nn.Dense`` semantics over the last axis."""

    def __init__(self, in_f, out_f, *, init=normal_init, dtype=None, device=None):
        super().__init__()
        self.dtype, self._init = dtype, init
        self.weight = nn.Parameter(torch.empty(out_f, in_f, device=device))
        self.bias = nn.Parameter(torch.empty(out_f, device=device))

    def init_from(self, g):
        self._init(self.weight, g)
        self.bias.zero_()

    def forward(self, x):
        dt = _dt(self.dtype, x, self.weight)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def upsample_nearest_2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avg_pool_2x(x):
    return F.avg_pool2d(x, 2)


class UpsampleConv3x3(_Init):
    """``conv3x3(upsample_nearest_2x(x))`` through the subpixel decomposition
    (eval form). ``combined``: the phase kernel in the compute dtype, set by
    the sampler for the length of one call (models/bridge.py) so the combine
    runs once per call, not per step; None combines in the call.

    In training mode it is the naive upsample + conv + bias, the JAX package's
    own training form (``bbdm_tpu/models/layers.py:139-148``): the combine
    cannot be hoisted when the weights change every step."""

    def __init__(self, in_ch, out_ch, *, init=normal_init, dtype=None, device=None):
        super().__init__()
        self.dtype, self._init = dtype, init
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))
        self.combined = None

    def init_from(self, g):
        self._init(self.weight, g)
        self.bias.zero_()

    def forward(self, x):
        if self.training:
            dt = _dt(self.dtype, x, self.weight)
            out = F.conv2d(upsample_nearest_2x(x).to(dt), self.weight.to(dt), padding=1)
            return out + self.bias.to(out.dtype)[:, None, None]
        return up_ops.upsample2x_conv3x3(x, self.weight, self.bias, dtype=self.dtype,
                                         combined=self.combined)


class Upsample(nn.Module):
    """2x nearest upsample, optionally followed by a 3x3 conv (``conv``)."""

    def __init__(self, ch, use_conv=True, *, dtype=None, device=None):
        super().__init__()
        self.conv = UpsampleConv3x3(ch, ch, dtype=dtype, device=device) if use_conv else None

    def forward(self, x):
        return self.conv(x) if self.conv is not None else upsample_nearest_2x(x)


class Downsample(nn.Module):
    """Stride-2 3x3 conv (``op``) or 2x average pool."""

    def __init__(self, ch, use_conv=True, *, dtype=None, device=None):
        super().__init__()
        self.op = conv3x3(ch, ch, stride=2, dtype=dtype, device=device) if use_conv else None

    def forward(self, x):
        return self.op(x) if self.op is not None else avg_pool_2x(x)


class ResBlock(nn.Module):
    """Timestep-conditioned residual block (``bbdm_tpu/models/layers.py:196-248``).

    in: GN -> SiLU -> [up: subpixel up-conv | down: avg-pool, conv3x3 | conv3x3];
    emb: SiLU -> Dense (2*out when scale-shift: [scale, shift] into the out GN);
    out: GN [FiLM] -> SiLU -> dropout (training mode only) -> conv3x3; skip:
    identity or 1x1 conv, with the same up (nearest) / down (avg-pool)
    resampling.
    """

    def __init__(self, in_ch, out_ch, emb_ch, *, use_scale_shift_norm=False, up=False,
                 down=False, dropout=0.0, init_scheme="reference", dtype=None, device=None):
        super().__init__()
        self.up, self.down, self.use_scale_shift_norm = up, down, use_scale_shift_norm
        self.dropout = dropout
        kw = dict(dtype=dtype, device=device)
        self.in_norm = GroupNorm32(in_ch, device=device)
        if up:
            self.in_conv = UpsampleConv3x3(in_ch, out_ch, **kw)
        else:
            self.in_conv = conv3x3(in_ch, out_ch, **kw)
        self.emb_proj = Dense(emb_ch, 2 * out_ch if use_scale_shift_norm else out_ch, **kw)
        self.out_norm = GroupNorm32(out_ch, device=device)
        self.out_conv = conv3x3(out_ch, out_ch, init=head_init(init_scheme), **kw)
        self.skip = conv1x1(in_ch, out_ch, **kw) if in_ch != out_ch else None

    def forward(self, x, emb):
        h = self.in_norm(x, act="silu")
        if self.up:
            x = upsample_nearest_2x(x)
        elif self.down:
            h = avg_pool_2x(h)
            x = avg_pool_2x(x)
        h = self.in_conv(h)
        emb_out = self.emb_proj(F.silu(emb))
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.out_norm(h, act="silu", film_scale=scale, film_shift=shift)
        else:
            h = h + emb_out[:, :, None, None].to(h.dtype)
            h = self.out_norm(h, act="silu")
        if self.dropout > 0.0:
            h = F.dropout(h, self.dropout, training=self.training)
        h = self.out_conv(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over H*W tokens with the legacy per-head
    ``[q | k | v]`` channel split (``bbdm_tpu/models/layers.py:251-276``)."""

    def __init__(self, ch, num_heads, *, dtype=None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(ch, device=device)
        self.qkv = Dense(ch, 3 * ch, init=torch_default_init, dtype=dtype, device=device)
        self.proj_out = Dense(ch, ch, init=zeros_init, dtype=dtype, device=device)

    def forward(self, x):
        B, C, H, W = x.shape
        T = H * W
        h = self.norm(x).reshape(B, C, T).transpose(1, 2)  # [B, T, C]
        qkv = self.qkv(h).reshape(B, T, self.num_heads, 3, C // self.num_heads)
        q, k, v = (qkv[:, :, :, i].transpose(1, 2).contiguous() for i in range(3))
        a = attn_ops.multi_head_attention(q, k, v)  # [B, heads, T, d]
        a = self.proj_out(a.transpose(1, 2).reshape(B, T, C))
        return x + a.transpose(1, 2).reshape(B, C, H, W)
