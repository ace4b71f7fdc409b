"""The guided-diffusion UNet denoiser, NCHW (port of ``bbdm_tpu/models/unet.py``).

Same module names and channel flow as the flax ``UNet``: a conv stem, per
channel_mult level ``num_res_blocks`` ResBlocks (+ attention when the
downsampling factor is in ``attention_resolutions``) and a down ResBlock or
Downsample; middle ResBlock -> attention -> ResBlock; a mirrored decoder that
concatenates ``[h, skip]`` and ends each level but the first with an up
ResBlock or Upsample; head GN -> SiLU -> fp32 conv. The time MLP runs in fp32
(flax ``dtype=None`` on an fp32 input).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bbdm_tpu_torch.models.layers import (
    AttentionBlock,
    Dense,
    Downsample,
    GroupNorm32,
    ResBlock,
    Upsample,
    conv3x3,
    head_init,
    timestep_embedding,
)


class UNet(nn.Module):
    def __init__(self, *, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int,
                 attention_resolutions: Sequence[int], dropout=0.0, channel_mult=(1, 2, 4, 8),
                 conv_resample=True, dims=2, num_heads=-1, num_head_channels=-1,
                 num_heads_upsample=-1, use_scale_shift_norm=False,
                 resblock_updown=False, use_spatial_transformer=False,
                 condition_key="nocond", init_scheme="reference",
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if dims != 2:
            raise NotImplementedError("only dims=2 (NCHW images) is supported")
        if use_spatial_transformer:
            raise NotImplementedError("use_spatial_transformer is not ported yet")
        self.model_channels, self.num_res_blocks = model_channels, num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.num_heads, self.num_head_channels = num_heads, num_head_channels
        self.num_heads_upsample = num_heads_upsample
        self.condition_key, self.dtype = condition_key, dtype

        mc = model_channels
        emb_ch = 4 * mc
        self.time_dense_0 = Dense(mc, emb_ch, device=device)
        self.time_dense_1 = Dense(emb_ch, emb_ch, device=device)

        def res(name, cin, cout, **kw):
            self.add_module(name, ResBlock(
                cin, cout, emb_ch, use_scale_shift_norm=use_scale_shift_norm, dropout=dropout,
                init_scheme=init_scheme, dtype=dtype, device=device, **kw))

        def attention(name, ch, decoder=False):
            self.add_module(name, AttentionBlock(
                ch, self._heads_for(ch, decoder), dtype=dtype, device=device))

        self.stem = conv3x3(in_channels, mc, dtype=dtype, device=device)
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(self.channel_mult):
            for i in range(num_res_blocks):
                res(f"down_{level}_{i}", ch, mult * mc)
                ch = mult * mc
                if ds in self.attention_resolutions:
                    attention(f"down_{level}_{i}_attn", ch)
                chans.append(ch)
            if level != len(self.channel_mult) - 1:
                if resblock_updown:
                    res(f"down_{level}_ds", ch, ch, down=True)
                else:
                    self.add_module(f"down_{level}_ds", Downsample(
                        ch, conv_resample, dtype=dtype, device=device))
                chans.append(ch)
                ds *= 2

        res("mid_res_0", ch, ch)
        attention("mid_attn", ch)
        res("mid_res_1", ch, ch)

        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(num_res_blocks + 1):
                res(f"up_{level}_{i}", ch + chans.pop(), mult * mc)
                ch = mult * mc
                if ds in self.attention_resolutions:
                    attention(f"up_{level}_{i}_attn", ch, decoder=True)
                if level and i == num_res_blocks:
                    if resblock_updown:
                        res(f"up_{level}_us", ch, ch, up=True)
                    else:
                        self.add_module(f"up_{level}_us", Upsample(
                            ch, conv_resample, dtype=dtype, device=device))
                    ds //= 2

        self.out_norm = GroupNorm32(ch, device=device)
        self.out_conv = conv3x3(ch, out_channels, init=head_init(init_scheme),
                                dtype=torch.float32, device=device)

    def _heads_for(self, ch: int, decoder: bool = False) -> int:
        """Head count of the legacy arithmetic (``bbdm_tpu/models/unet.py:73-93``)."""
        if self.num_head_channels == -1:
            if decoder and self.num_heads_upsample != -1:
                return self.num_heads_upsample
            return self.num_heads
        return ch // self.num_head_channels

    def forward(self, x, timesteps, context=None):
        """x: [B, C, H, W]; timesteps: [B]. Returns [B, out_channels, H, W] fp32."""
        emb = self.time_dense_0(timestep_embedding(timesteps, self.model_channels))
        emb = self.time_dense_1(F.silu(emb))
        if self.condition_key != "nocond" and context is not None:
            x = torch.cat([x, context.to(x.dtype)], dim=1)
        h = x.to(self.dtype)
        emb = emb.to(self.dtype)
        block = self.get_submodule

        hs = [self.stem(h)]
        h = hs[0]
        ds = 1
        for level, _ in enumerate(self.channel_mult):
            for i in range(self.num_res_blocks):
                h = block(f"down_{level}_{i}")(h, emb)
                if ds in self.attention_resolutions:
                    h = block(f"down_{level}_{i}_attn")(h)
                hs.append(h)
            if level != len(self.channel_mult) - 1:
                ds_block = block(f"down_{level}_ds")
                h = ds_block(h, emb) if isinstance(ds_block, ResBlock) else ds_block(h)
                hs.append(h)
                ds *= 2

        h = self.mid_res_0(h, emb)
        h = self.mid_attn(h)
        h = self.mid_res_1(h, emb)

        for level, _ in reversed(list(enumerate(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = block(f"up_{level}_{i}")(torch.cat([h, hs.pop()], dim=1), emb)
                if ds in self.attention_resolutions:
                    h = block(f"up_{level}_{i}_attn")(h)
                if level and i == self.num_res_blocks:
                    us_block = block(f"up_{level}_us")
                    h = us_block(h, emb) if isinstance(us_block, ResBlock) else us_block(h)
                    ds //= 2

        h = self.out_norm(h, act="silu")
        return self.out_conv(h.float())

    @staticmethod
    def from_config(p, condition_key: str, *, dtype=torch.bfloat16,
                    init_scheme: str = "reference", device=None) -> "UNet":
        """Build from a ``UNetParams`` config node."""
        return UNet(
            in_channels=p.in_channels,
            model_channels=p.model_channels, out_channels=p.out_channels,
            num_res_blocks=p.num_res_blocks,
            attention_resolutions=tuple(p.attention_resolutions),
            dropout=p.get("dropout", 0.0), channel_mult=tuple(p.channel_mult),
            conv_resample=p.get("conv_resample", True), dims=p.get("dims", 2),
            num_heads=p.get("num_heads", -1),
            num_head_channels=p.get("num_head_channels", -1),
            num_heads_upsample=p.get("num_heads_upsample", -1),
            use_scale_shift_norm=p.get("use_scale_shift_norm", False),
            resblock_updown=p.get("resblock_updown", False),
            use_spatial_transformer=p.get("use_spatial_transformer", False),
            condition_key=condition_key, init_scheme=init_scheme,
            dtype=dtype, device=device,
        )
