"""VQGAN first stage, NCHW (port of ``bbdm_tpu/models/vqgan.py``).

GroupNorm eps is 1e-6. The encoder's and decoder's ``conv_out`` run in fp32;
``quant_conv``/``post_quant_conv`` take their dtype from their fp32 input; the
quantizers are fp32: the nearest-neighbour one (d = |z|^2 + |e|^2 - 2 z e^T,
argmin, straight-through gradient, commitment loss) and the Gumbel-softmax one.
:meth:`VQModel.forward` is the training roundtrip ``(xrec, qloss)``.

The decoder's up-convs follow the module's mode (``layers.UpsampleConv3x3``):
in training mode the naive upsample + conv, which has a gradient; in eval mode
the subpixel decomposition (kernel K2 on the card).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bbdm_tpu_torch.models.discriminator import NLayerDiscriminator
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
from bbdm_tpu_torch.parallel import collectives

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
    """Nearest-neighbour codebook quantizer with straight-through gradients and
    the legacy-beta commitment loss (``bbdm_tpu/models/vqgan.py:181-217``)."""

    def __init__(self, n_e, e_dim, beta=0.25, *, device=None):
        super().__init__()
        self.n_e, self.e_dim, self.beta = n_e, e_dim, beta
        self.embedding = nn.Parameter(torch.empty(n_e, e_dim, device=device))

    def init_from(self, g):
        self.embedding.uniform_(-1.0 / self.n_e, 1.0 / self.n_e, generator=g)

    def nearest(self, z):
        """z: [B, C, H, W] -> the index of each position's nearest code, [B*H*W]."""
        flat = z.float().permute(0, 2, 3, 1).reshape(-1, self.e_dim)
        e = self.embedding.float()
        d = ((flat * flat).sum(1, keepdim=True) + (e * e).sum(1)[None, :]
             - 2.0 * (flat @ e.T))
        return d.argmin(1)

    def forward(self, z):
        """z: [B, C, H, W] -> (z_q [B, C, H, W] in z.dtype, loss, indices [B, H, W])."""
        B, C, H, W = z.shape
        zf = z.float()
        idx = self.nearest(z)
        z_q = self.embedding.float()[idx].reshape(B, H, W, C).permute(0, 3, 1, 2)
        loss = ((z_q.detach() - zf) ** 2).mean() + self.beta * ((z_q - zf.detach()) ** 2).mean()
        z_q = zf + (z_q - zf).detach()  # straight-through
        return z_q.to(z.dtype), loss, idx.reshape(B, H, W)


class GumbelQuantize(_Init):
    """Gumbel-softmax quantizer (``bbdm_tpu/models/vqgan.py:220-269``): a 1x1
    ``proj`` to ``n_e`` logits, a (hard straight-through) one-hot over the
    codebook, z_q = one_hot @ codebook, loss ``kl_weight`` * KL(q || uniform).
    In training the logits get Gumbel noise -log(-log u), u uniform in
    [tiny, 1): ``u`` ([B, n_e, H, W]) when given (tests feed the JAX draws),
    else drawn from ``generator`` at the global batch's shape, this rank's rows
    kept; outside training no noise (argmax)."""

    def __init__(self, n_e, e_dim, kl_weight=5e-4, straight_through=True, *, device=None):
        super().__init__()
        self.n_e, self.e_dim = n_e, e_dim
        self.kl_weight, self.straight_through = kl_weight, straight_through
        self.proj = Conv2d(e_dim, n_e, 1, init=_init, device=device)
        self.embedding = nn.Parameter(torch.empty(n_e, e_dim, device=device))

    def init_from(self, g):
        self.embedding.normal_(0.0, 1.0, generator=g)

    def forward(self, z, *, temp=1.0, train=False, u=None, generator=None):
        zf = z.float()
        logits = self.proj(zf)  # [B, n_e, H, W]
        if train:
            if u is None:
                u = collectives.rand(logits.shape, generator=generator, device=logits.device)
                u = u.clamp_min(torch.finfo(torch.float32).tiny)
            noisy = logits - torch.log(-torch.log(u))
        else:
            noisy = logits
        soft = torch.softmax(noisy / temp, dim=1)
        idx = soft.argmax(1)
        if not train or self.straight_through:
            hard = F.one_hot(idx, self.n_e).permute(0, 3, 1, 2).float()
            one_hot = hard + soft - soft.detach()
        else:
            one_hot = soft
        z_q = torch.einsum("bnhw,nd->bdhw", one_hot, self.embedding.float())
        qy = torch.softmax(logits, dim=1)
        kl = (qy * torch.log(qy * self.n_e + 1e-10)).sum(1).mean()
        return z_q.to(z.dtype), self.kl_weight * kl, idx


class VQModel(nn.Module):
    """Encoder + quantizer + decoder with the 1x1 quant convs; the piecemeal
    methods LBBDM calls and the training roundtrip :meth:`forward`.
    ``quantizer_type``: "nearest" or "gumbel"."""

    def __init__(self, ddconfig: dict, n_embed: int, embed_dim: int, *,
                 quantizer_type="nearest", kl_weight=5e-4, dtype=None, device=None):
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
        self.quantizer_type = quantizer_type
        if quantizer_type == "gumbel":
            self.quantize = GumbelQuantize(n_embed, embed_dim, kl_weight=kl_weight,
                                           device=device)
        elif quantizer_type == "nearest":
            self.quantize = VectorQuantizer(n_embed, embed_dim, device=device)
        else:
            raise ValueError(f"unknown quantizer_type {quantizer_type!r}")
        z = dd["z_channels"]
        self.quant_conv = Conv2d(z, embed_dim, 1, init=_init, device=device)
        self.post_quant_conv = Conv2d(embed_dim, z, 1, init=_init, device=device)

    def encode_pre_quant(self, x):
        return self.encoder(x)

    def encode_latent(self, x):
        """encoder -> quant_conv, no quantisation."""
        return self.quant_conv(self.encoder(x))

    def quantize_latent(self, h, *, temp=1.0, train=False, u=None, generator=None):
        """(z_q, loss, indices); ``temp``, ``train``, ``u`` and ``generator``
        reach the Gumbel quantizer only."""
        if self.quantizer_type == "gumbel":
            return self.quantize(h, temp=temp, train=train, u=u, generator=generator)
        return self.quantize(h)

    def apply_quant_conv(self, h):
        return self.quant_conv(h)

    def decode_from_quant(self, quant):
        """post_quant_conv -> decoder."""
        return self.decoder(self.post_quant_conv(quant))

    def forward(self, x, *, temp=1.0, train=False, u=None, generator=None):
        """The autoencode roundtrip -> (xrec, quantizer loss)."""
        quant, qloss, _ = self.quantize_latent(self.encode_latent(x), temp=temp, train=train,
                                               u=u, generator=generator)
        return self.decode_from_quant(quant), qloss

    @staticmethod
    def from_config(vq_params, *, dtype=None, device=None) -> "VQModel":
        dd = vq_params.ddconfig
        ddconfig = {
            "ch": dd.ch, "ch_mult": tuple(dd.ch_mult), "num_res_blocks": dd.num_res_blocks,
            "attn_resolutions": tuple(dd.attn_resolutions), "resolution": dd.resolution,
            "z_channels": dd.z_channels, "in_channels": dd.in_channels, "out_ch": dd.out_ch,
            "double_z": dd.get("double_z", False),
        }
        return VQModel(ddconfig, vq_params.n_embed, vq_params.embed_dim,
                       quantizer_type=vq_params.get("quantizer", "nearest"),
                       kl_weight=vq_params.get("kl_weight", 5e-4), dtype=dtype, device=device)


class VQGANTrainModel(nn.Module):
    """The VQ autoencoder (``vqgan``) with its PatchGAN critic
    (``discriminator``), built from a ``model_type: VQGAN`` config: the
    ``VQGAN.params`` autoencoder and the ``loss`` keys ``disc_ndf`` (64),
    ``disc_num_layers`` (3) and ``use_actnorm`` (False)."""

    def __init__(self, model_config, *, dtype=None, device=None):
        super().__init__()
        self.vqgan = VQModel.from_config(model_config.VQGAN.params, dtype=dtype, device=device)
        loss = model_config.get("loss", None)
        get = (lambda k, d: loss.get(k, d)) if loss is not None else (lambda k, d: d)
        self.discriminator = NLayerDiscriminator(
            model_config.VQGAN.params.ddconfig.in_channels, ndf=get("disc_ndf", 64),
            n_layers=get("disc_num_layers", 3), use_actnorm=get("use_actnorm", False),
            dtype=dtype, device=device)
