"""Condition-stage encoders (port of ``bbdm_tpu/models/cond.py:21-121``).

``SpatialRescaler``: ``n_stages`` bilinear downscalings by ``multiplier`` (no
antialiasing, half-pixel centres, as ``jax.image.resize`` with
``antialias=False``), then an optional 1x1 ``channel_mapper`` conv without
bias. LBBDM's ``condition_key: SpatialRescaler`` context.

``ClassEmbedder`` and ``TransformerEmbedder``: cross-attention contexts
[B, S, C] from class labels or token ids, for a UNet with
``use_spatial_transformer``. The JAX package's ``BERTEmbedder`` needs a
pretrained tokenizer vocabulary the repository does not hold, and is not
ported.
"""

from __future__ import annotations

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


class SpatialRescaler(nn.Module):
    def __init__(self, in_channels=3, *, n_stages=1, method="bilinear", multiplier=0.5,
                 out_channels=None, bias=False, dtype=None, device=None):
        super().__init__()
        if method != "bilinear":
            raise NotImplementedError(f"SpatialRescaler method {method!r} is not ported")
        self.n_stages, self.multiplier = n_stages, multiplier
        self.channel_mapper = None
        if out_channels is not None:
            self.channel_mapper = conv1x1(in_channels, out_channels, bias=bias, dtype=dtype,
                                          device=device)

    def forward(self, x):
        """x: [B, C, H, W] -> [B, C', H * m^n, W * m^n]."""
        for _ in range(self.n_stages):
            H, W = x.shape[-2:]
            x = F.interpolate(x, size=(int(H * self.multiplier), int(W * self.multiplier)),
                              mode="bilinear", align_corners=False, antialias=False)
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
            keep = torch.rand(h.shape, generator=generator, device=h.device) >= p
            h = torch.where(keep, h / (1.0 - p), torch.zeros_like(h))
        if self.dtype is not None:
            h = h.to(self.dtype)
        layer = self.get_submodule
        for i in range(self.n_layer):
            h = h + layer(f"attn_{i}")(layer(f"ln_attn_{i}")(h))
            f = layer(f"ff_in_{i}")(layer(f"ln_ff_{i}")(h))
            h = h + layer(f"ff_out_{i}")(F.gelu(f, approximate="tanh"))
        return self.ln_final(h).float()
