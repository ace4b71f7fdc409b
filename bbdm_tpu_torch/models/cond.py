"""Condition-stage encoders (port of ``bbdm_tpu/models/cond.py:21-121``).

``SpatialRescaler``: ``n_stages`` rescalings by ``multiplier`` with the
configured ``method``, computed as ``jax.image.resize(..., antialias=False)``
computes them (:func:`resize`), then an optional 1x1 ``channel_mapper`` conv
without bias. LBBDM's ``condition_key: SpatialRescaler`` context.

``ClassEmbedder`` and ``TransformerEmbedder``: cross-attention contexts
[B, S, C] from class labels or token ids, for a UNet with
``use_spatial_transformer``. The JAX package's ``BERTEmbedder`` needs a
pretrained tokenizer vocabulary the repository does not hold, and is not
ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bbdm_tpu_torch.models.layers import (
    Dense,
    Embed,
    LayerNorm,
    MultiHeadDotProductAttention,
    _Init,
    conv1x1,
    lecun_normal_init,
)
from bbdm_tpu_torch.parallel import collectives


# jax.image.resize's method names -> its five methods
RESIZE_METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
                  "trilinear": "linear", "triangle": "linear", "cubic": "cubic",
                  "bicubic": "cubic", "tricubic": "cubic", "lanczos3": "lanczos3",
                  "lanczos5": "lanczos5"}


def _kernel(kind, x):
    """jax/_src/image/scale.py's kernels at distances x >= 0: the triangle, Keys
    cubic with a = -0.5, Lanczos of radius 3 or 5."""
    if kind == "linear":
        return torch.clamp(1 - x, min=0)
    if kind == "cubic":
        out = ((1.5 * x - 2.5) * x) * x + 1.0
        out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
        return torch.where(x >= 2.0, 0.0, out)
    radius = 3.0 if kind == "lanczos3" else 5.0
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * x ** 2, 1.0), 1.0)
    return torch.where(x > radius, 0.0, out)


def resize_weights(n_in, n_out, kind, device=None):
    """float32 [n_in, n_out]: output sample j = sum_i input_i * w[i, j], as
    ``jax.image.compute_weight_mat`` with ``antialias=False`` builds it: sample
    points at half-pixel centres, each column renormalised over the taps that
    fall inside the input, columns whose point lies outside it zero."""
    inv_scale = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    w = _kernel(kind, x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize(x, size, method="bilinear"):
    """x: [B, C, H, W] -> [B, C, *size] as ``jax.image.resize(x, shape, method,
    antialias=False)`` on the NHWC array: an axis whose size stays is left as
    it is; ``nearest`` takes the input sample under each output pixel's centre,
    the other methods contract each axis (H first) with :func:`resize_weights`.
    An unknown ``method`` raises ValueError, as JAX raises."""
    if method not in RESIZE_METHODS:
        raise ValueError(f'Unknown resize method "{method}"')
    kind = RESIZE_METHODS[method]
    for dim, n_out in ((2, size[0]), (3, size[1])):
        n_in = x.shape[dim]
        if n_in == n_out:
            continue
        if kind == "nearest":
            at = torch.floor((torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5)
                             * n_in / n_out).long()
            x = x.index_select(dim, at)
        else:
            w = resize_weights(n_in, n_out, kind, x.device).to(x.dtype)
            x = torch.einsum("bchw,hk->bckw" if dim == 2 else "bchw,wk->bchk", x, w)
    return x


class SpatialRescaler(nn.Module):
    def __init__(self, in_channels=3, *, n_stages=1, method="bilinear", multiplier=0.5,
                 out_channels=None, bias=False, dtype=None, device=None):
        super().__init__()
        if method not in RESIZE_METHODS:
            raise ValueError(f'Unknown resize method "{method}"')
        self.n_stages, self.method, self.multiplier = n_stages, method, multiplier
        self.channel_mapper = None
        if out_channels is not None:
            self.channel_mapper = conv1x1(in_channels, out_channels, bias=bias, dtype=dtype,
                                          device=device)

    def forward(self, x):
        """x: [B, C, H, W] -> [B, C', H * m^n, W * m^n]."""
        for _ in range(self.n_stages):
            H, W = x.shape[-2:]
            x = resize(x, (int(H * self.multiplier), int(W * self.multiplier)), self.method)
        return self.channel_mapper(x) if self.channel_mapper is not None else x

    @staticmethod
    def from_config(cond_params, *, dtype=None, device=None) -> "SpatialRescaler":
        return SpatialRescaler(
            cond_params.get("in_channels", 3), n_stages=cond_params.get("n_stages", 1),
            method=cond_params.get("method", "bilinear"),
            multiplier=cond_params.get("multiplier", 0.5),
            out_channels=cond_params.get("out_channels", None),
            bias=cond_params.get("bias", False), dtype=dtype, device=device)


class ClassEmbedder(nn.Module):
    """Class labels [B] -> a [B, 1, embed_dim] fp32 context: one row of the
    N(0, 1) table ``embedding`` per label (``bbdm_tpu/models/cond.py:56-70``)."""

    def __init__(self, embed_dim, n_classes=1000, *, device=None):
        super().__init__()
        self.embedding = Embed(n_classes, embed_dim, std=1.0, device=device)

    def forward(self, labels):
        return self.embedding(labels)[:, None, :]


class TransformerEmbedder(_Init):
    """Token ids [B, S] -> a [B, S, n_embed] fp32 context
    (``bbdm_tpu/models/cond.py:73-121``): token embedding plus the learned
    ``pos_emb`` (both N(0, 0.02^2)), dropout, then ``n_layer`` pre-norm blocks
    (LayerNorm -> multi-head self-attention -> residual; LayerNorm -> Dense
    4x -> tanh-GELU -> Dense -> residual) in ``dtype``, with fp32 LayerNorms,
    and a final fp32 LayerNorm. Dropout draws from ``generator``."""

    def __init__(self, n_embed, n_layer, vocab_size, max_seq_len=77, num_heads=8,
                 embedding_dropout=0.0, *, dtype=None, device=None):
        super().__init__()
        self.n_layer, self.max_seq_len, self.dtype = n_layer, max_seq_len, dtype
        self.embedding_dropout = embedding_dropout
        self.token_emb = Embed(vocab_size, n_embed, std=0.02, device=device)
        self.pos_emb = nn.Parameter(torch.empty(max_seq_len, n_embed, device=device))
        for i in range(n_layer):
            self.add_module(f"ln_attn_{i}", LayerNorm(n_embed, device=device))
            self.add_module(f"attn_{i}", MultiHeadDotProductAttention(
                n_embed, num_heads, dtype=dtype, device=device))
            self.add_module(f"ln_ff_{i}", LayerNorm(n_embed, device=device))
            self.add_module(f"ff_in_{i}", Dense(n_embed, 4 * n_embed,
                                                init=lecun_normal_init(n_embed), dtype=dtype,
                                                device=device))
            self.add_module(f"ff_out_{i}", Dense(4 * n_embed, n_embed,
                                                 init=lecun_normal_init(4 * n_embed),
                                                 dtype=dtype, device=device))
        self.ln_final = LayerNorm(n_embed, device=device)

    def init_from(self, g):
        self.pos_emb.normal_(0.0, 0.02, generator=g)

    def forward(self, tokens, *, generator: Optional[torch.Generator] = None):
        B, S = tokens.shape
        if S > self.max_seq_len:
            raise ValueError(f"sequence length {S} > max_seq_len {self.max_seq_len}")
        h = self.token_emb(tokens) + self.pos_emb[:S]
        p = self.embedding_dropout
        if self.training and p > 0.0:  # flax nn.Dropout: keep with 1 - p, scale by 1/(1 - p)
            keep = collectives.rand(h.shape, generator=generator, device=h.device) >= p
            h = torch.where(keep, h / (1.0 - p), torch.zeros_like(h))
        if self.dtype is not None:
            h = h.to(self.dtype)
        layer = self.get_submodule
        for i in range(self.n_layer):
            h = h + layer(f"attn_{i}")(layer(f"ln_attn_{i}")(h))
            f = layer(f"ff_in_{i}")(layer(f"ln_ff_{i}")(h))
            h = h + layer(f"ff_out_{i}")(F.gelu(f, approximate="tanh"))
        return self.ln_final(h).float()
