"""VQGAN first stage, inference subset, NCHW (port of ``bbdm_tpu/models/vqgan.py``).

GroupNorm eps is 1e-6. The encoder's and decoder's ``conv_out`` run in fp32;
``quant_conv``/``post_quant_conv`` take their dtype from their fp32 input; the
quantizer is fp32: d = |z|^2 + |e|^2 - 2 z e^T, argmin.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bbdm_tpu_torch.models.layers import (
    Conv2d,
    GroupNorm32,
    UpsampleConv3x3,
    _Init,
    avg_pool_2x,
    torch_default_init,
    upsample_nearest_2x,
)
from bbdm_tpu_torch.ops import attention as attn_ops

_init = torch_default_init  # the VQGAN keeps torch's default init


def _conv(cin, cout, kernel, *, dtype, device, padding=None):
    return Conv2d(cin, cout, kernel, padding=kernel // 2 if padding is None else padding,
                  init=_init, dtype=dtype, device=device)


class VQResnetBlock(nn.Module):
    """GN -> SiLU -> conv3x3, twice, with a 1x1 shortcut when widths differ."""

    def __init__(self, in_ch, out_ch, *, dtype=None, device=None):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6, device=device)
        self.conv1 = _conv(in_ch, out_ch, 3, dtype=dtype, device=device)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6, device=device)
        self.conv2 = _conv(out_ch, out_ch, 3, dtype=dtype, device=device)
        self.nin_shortcut = (_conv(in_ch, out_ch, 1, dtype=dtype, device=device)
                             if in_ch != out_ch else None)

    def forward(self, x):
        h = self.conv1(self.norm1(x, act="silu"))
        h = self.conv2(self.norm2(h, act="silu"))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class VQAttnBlock(nn.Module):
    """Single-head spatial self-attention with 1x1-conv projections."""

    def __init__(self, ch, *, dtype=None, device=None):
        super().__init__()
        self.norm = GroupNorm32(ch, eps=1e-6, device=device)
        for name in ("q", "k", "v", "proj_out"):
            self.add_module(name, _conv(ch, ch, 1, dtype=dtype, device=device))

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)

        def tokens(t):  # [B, C, H, W] -> [B, 1, T, C]
            return t.reshape(B, C, H * W).transpose(1, 2).unsqueeze(1).contiguous()

        a = attn_ops.multi_head_attention(tokens(self.q(h)), tokens(self.k(h)),
                                          tokens(self.v(h)))
        a = a.squeeze(1).transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(a)


class VQDownsample(nn.Module):
    """Stride-2 3x3 conv with (0, 1, 0, 1) padding (right/bottom only), or avg-pool."""

    def __init__(self, ch, with_conv=True, *, dtype=None, device=None):
        super().__init__()
        self.conv = (Conv2d(ch, ch, 3, stride=2, padding=0, init=_init, dtype=dtype,
                            device=device) if with_conv else None)

    def forward(self, x):
        if self.conv is None:
            return avg_pool_2x(x)
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VQUpsample(nn.Module):
    """Nearest 2x upsample + 3x3 conv through the subpixel decomposition."""

    def __init__(self, ch, with_conv=True, *, dtype=None, device=None):
        super().__init__()
        self.conv = (UpsampleConv3x3(ch, ch, init=_init, dtype=dtype, device=device)
                     if with_conv else None)

    def forward(self, x):
        return self.conv(x) if self.conv is not None else upsample_nearest_2x(x)


class VQEncoder(nn.Module):
    def __init__(self, *, ch, ch_mult: Sequence[int], num_res_blocks, attn_resolutions,
                 resolution, in_channels, z_channels, double_z=False, resamp_with_conv=True,
                 dtype=None, device=None):
        super().__init__()
        self.ch_mult, self.num_res_blocks = tuple(ch_mult), num_res_blocks
        self.attn_resolutions, self.resolution = tuple(attn_resolutions), resolution
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.conv_in = _conv(in_channels, ch, 3, **kw)
        cin, curr_res = ch, resolution
        for i_level, mult in enumerate(self.ch_mult):
            for i_block in range(num_res_blocks):
                self.add_module(f"down_{i_level}_block_{i_block}",
                                VQResnetBlock(cin, ch * mult, **kw))
                cin = ch * mult
                if curr_res in self.attn_resolutions:
                    self.add_module(f"down_{i_level}_attn_{i_block}", VQAttnBlock(cin, **kw))
            if i_level != len(self.ch_mult) - 1:
                self.add_module(f"down_{i_level}_downsample",
                                VQDownsample(cin, resamp_with_conv, **kw))
                curr_res //= 2
        self.mid_block_1 = VQResnetBlock(cin, cin, **kw)
        self.mid_attn_1 = VQAttnBlock(cin, **kw)
        self.mid_block_2 = VQResnetBlock(cin, cin, **kw)
        self.norm_out = GroupNorm32(cin, eps=1e-6, device=device)
        self.conv_out = _conv(cin, 2 * z_channels if double_z else z_channels, 3,
                              dtype=torch.float32, device=device)

    def forward(self, x):
        h = self.conv_in(x.to(self.dtype or x.dtype))
        curr_res = self.resolution
        for i_level, _ in enumerate(self.ch_mult):
            for i_block in range(self.num_res_blocks):
                h = self.get_submodule(f"down_{i_level}_block_{i_block}")(h)
                if curr_res in self.attn_resolutions:
                    h = self.get_submodule(f"down_{i_level}_attn_{i_block}")(h)
            if i_level != len(self.ch_mult) - 1:
                h = self.get_submodule(f"down_{i_level}_downsample")(h)
                curr_res //= 2
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        h = self.norm_out(h, act="silu")
        return self.conv_out(h.float())


class VQDecoder(nn.Module):
    def __init__(self, *, ch, out_ch, ch_mult: Sequence[int], num_res_blocks,
                 attn_resolutions, resolution, z_channels, resamp_with_conv=True,
                 dtype=None, device=None):
        super().__init__()
        self.ch_mult, self.num_res_blocks = tuple(ch_mult), num_res_blocks
        self.attn_resolutions, self.resolution = tuple(attn_resolutions), resolution
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        n = len(self.ch_mult)
        block_in = ch * self.ch_mult[-1]
        curr_res = resolution // 2 ** (n - 1)
        self.conv_in = _conv(z_channels, block_in, 3, **kw)
        self.mid_block_1 = VQResnetBlock(block_in, block_in, **kw)
        self.mid_attn_1 = VQAttnBlock(block_in, **kw)
        self.mid_block_2 = VQResnetBlock(block_in, block_in, **kw)
        cin = block_in
        for i_level in reversed(range(n)):
            for i_block in range(num_res_blocks + 1):
                self.add_module(f"up_{i_level}_block_{i_block}",
                                VQResnetBlock(cin, ch * self.ch_mult[i_level], **kw))
                cin = ch * self.ch_mult[i_level]
                if curr_res in self.attn_resolutions:
                    self.add_module(f"up_{i_level}_attn_{i_block}", VQAttnBlock(cin, **kw))
            if i_level != 0:
                self.add_module(f"up_{i_level}_upsample", VQUpsample(cin, resamp_with_conv, **kw))
                curr_res *= 2
        self.norm_out = GroupNorm32(cin, eps=1e-6, device=device)
        self.conv_out = _conv(cin, out_ch, 3, dtype=torch.float32, device=device)

    def forward(self, z):
        h = self.conv_in(z.to(self.dtype or z.dtype))
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        curr_res = self.resolution // 2 ** (len(self.ch_mult) - 1)
        for i_level in reversed(range(len(self.ch_mult))):
            for i_block in range(self.num_res_blocks + 1):
                h = self.get_submodule(f"up_{i_level}_block_{i_block}")(h)
                if curr_res in self.attn_resolutions:
                    h = self.get_submodule(f"up_{i_level}_attn_{i_block}")(h)
            if i_level != 0:
                h = self.get_submodule(f"up_{i_level}_upsample")(h)
                curr_res *= 2
        h = self.norm_out(h, act="silu")
        return self.conv_out(h.float())


class VectorQuantizer(_Init):
    """Nearest-neighbour codebook lookup (inference forward)."""

    def __init__(self, n_e, e_dim, *, device=None):
        super().__init__()
        self.n_e, self.e_dim = n_e, e_dim
        self.embedding = nn.Parameter(torch.empty(n_e, e_dim, device=device))

    def init_from(self, g):
        self.embedding.uniform_(-1.0 / self.n_e, 1.0 / self.n_e, generator=g)

    def forward(self, z):
        """z: [B, C, H, W] -> (z_q [B, C, H, W] in z.dtype, indices [B, H, W])."""
        B, C, H, W = z.shape
        zf = z.float()
        flat = zf.permute(0, 2, 3, 1).reshape(-1, self.e_dim)
        e = self.embedding.float()
        d = ((flat * flat).sum(1, keepdim=True) + (e * e).sum(1)[None, :]
             - 2.0 * (flat @ e.T))
        idx = d.argmin(1)
        z_q = e[idx].reshape(B, H, W, C).permute(0, 3, 1, 2)
        # the straight-through expression of the JAX forward, kept for equal rounding
        z_q = zf + (z_q - zf)
        return z_q.to(z.dtype), idx.reshape(B, H, W)


class VQModel(nn.Module):
    """Encoder + quantizer + decoder with the 1x1 quant convs; the piecemeal
    methods LBBDM calls."""

    def __init__(self, ddconfig: dict, n_embed: int, embed_dim: int, *, dtype=None,
                 device=None):
        super().__init__()
        dd = ddconfig
        common = dict(ch=dd["ch"], ch_mult=tuple(dd["ch_mult"]),
                      num_res_blocks=dd["num_res_blocks"],
                      attn_resolutions=tuple(dd["attn_resolutions"]),
                      resolution=dd["resolution"], z_channels=dd["z_channels"],
                      dtype=dtype, device=device)
        self.encoder = VQEncoder(in_channels=dd["in_channels"],
                                 double_z=dd.get("double_z", False), **common)
        self.decoder = VQDecoder(out_ch=dd["out_ch"], **common)
        self.quantize = VectorQuantizer(n_embed, embed_dim, device=device)
        z = dd["z_channels"]
        self.quant_conv = Conv2d(z, embed_dim, 1, init=_init, device=device)
        self.post_quant_conv = Conv2d(embed_dim, z, 1, init=_init, device=device)

    def encode_pre_quant(self, x):
        return self.encoder(x)

    def encode_latent(self, x):
        """encoder -> quant_conv, no quantisation."""
        return self.quant_conv(self.encoder(x))

    def quantize_latent(self, h):
        return self.quantize(h)

    def apply_quant_conv(self, h):
        return self.quant_conv(h)

    def decode_from_quant(self, quant):
        """post_quant_conv -> decoder."""
        return self.decoder(self.post_quant_conv(quant))

    @staticmethod
    def from_config(vq_params, *, dtype=None, device=None) -> "VQModel":
        dd = vq_params.ddconfig
        if vq_params.get("quantizer", "nearest") != "nearest":
            raise NotImplementedError("only the nearest-neighbour quantizer is ported")
        ddconfig = {
            "ch": dd.ch, "ch_mult": tuple(dd.ch_mult), "num_res_blocks": dd.num_res_blocks,
            "attn_resolutions": tuple(dd.attn_resolutions), "resolution": dd.resolution,
            "z_channels": dd.z_channels, "in_channels": dd.in_channels, "out_ch": dd.out_ch,
            "double_z": dd.get("double_z", False),
        }
        return VQModel(ddconfig, vq_params.n_embed, vq_params.embed_dim, dtype=dtype,
                       device=device)
