"""PatchGAN discriminator with BatchNorm or ActNorm, NCHW (port of
``bbdm_tpu/models/discriminator.py``).

conv 4x4 stride 2 -> LeakyReLU(0.2), then ``n_layers`` of conv 4x4 (stride 2,
the last stride 1; no bias under BatchNorm) -> norm -> LeakyReLU(0.2), then a
conv 4x4 to one channel of patch logits. Parameter and buffer names are the
flax names: ``conv_<n>``, ``norm_<n>`` (``scale`` is ``weight``; flax's
``batch_stats`` ``mean`` / ``var`` are the buffers ``mean`` / ``var``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bbdm_tpu_torch.models.layers import Conv2d, _Init, torch_default_init
from bbdm_tpu_torch.parallel import collectives


class BatchNorm2d(_Init):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` over N, H, W.

    Train mode normalises with the batch's fp32 mean and biased variance
    E[x^2] - E[x]^2 (clipped at 0, flax's fast variance), both means over the
    global batch of a data-parallel run (with gradient through the reduction
    over ranks, as flax under GSPMD), and moves the running statistics in
    place: ``ra = momentum * ra + (1 - momentum) * batch``. Eval
    mode normalises with the running statistics. (``torch.nn.BatchNorm2d``
    keeps the unbiased variance and weighs the new value by its momentum.)
    Output in fp32."""

    def __init__(self, channels, momentum=0.9, eps=1e-5, *, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def init_from(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x, *, train: bool):
        xf = x.float()
        if train:
            mean, sq = collectives.batch_mean(
                torch.stack([xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))])).unbind(0)
            var = (sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class ActNorm(_Init):
    """Per-channel ``weight * (x + loc)`` in fp32, output in x's dtype (flax
    params ``loc``, ``scale``). The JAX package initialises both from the batch
    it is initialised with (loc = -mean, scale = 1 / (std + 1e-6)); its runner
    initialises on a zero image, which gives loc 0 and scale 1e6, as
    :meth:`init_from` does. Trained values come in through the checkpoint
    converters."""

    def __init__(self, channels, *, device=None):
        super().__init__()
        self.loc = nn.Parameter(torch.empty(channels, device=device))
        self.weight = nn.Parameter(torch.empty(channels, device=device))

    def init_from(self, g):
        self.loc.zero_()
        self.weight.fill_(1.0 / (0.0 + 1e-6))

    def forward(self, x, *, train: bool = False):
        xf = x.float()
        return (self.weight[:, None, None] * (xf + self.loc[:, None, None])).to(x.dtype)


class NLayerDiscriminator(nn.Module):
    """pix2pix PatchGAN (``bbdm_tpu/models/discriminator.py:36-65``).

    ``forward(x, train=False)``: ``train`` chooses the BatchNorm's batch
    statistics, which it then moves, over its running ones, as flax's
    ``train`` argument does (the module's mode plays no part)."""

    def __init__(self, in_channels=3, ndf=64, n_layers=3, use_actnorm=False, *, dtype=None,
                 device=None):
        super().__init__()
        self.n_layers, self.use_actnorm = n_layers, use_actnorm
        kw = dict(init=torch_default_init, dtype=dtype, device=device)
        self.conv_0 = Conv2d(in_channels, ndf, 4, stride=2, padding=1, **kw)
        nf = 1
        for n in range(1, n_layers + 1):
            prev, nf = nf, min(2 ** n, 8)
            self.add_module(f"conv_{n}", Conv2d(ndf * prev, ndf * nf, 4,
                                                stride=2 if n < n_layers else 1, padding=1,
                                                bias=use_actnorm, **kw))
            self.add_module(f"norm_{n}", ActNorm(ndf * nf, device=device) if use_actnorm
                            else BatchNorm2d(ndf * nf, device=device))
        self.conv_out = Conv2d(ndf * nf, 1, 4, padding=1, **kw)

    def forward(self, x, *, train: bool = False):
        h = F.leaky_relu(self.conv_0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            h = self.get_submodule(f"conv_{n}")(h)
            h = F.leaky_relu(self.get_submodule(f"norm_{n}")(h, train=train), 0.2)
        return self.conv_out(h)
