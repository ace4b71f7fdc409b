"""Condition-stage encoder ``SpatialRescaler`` (port of
``bbdm_tpu/models/cond.py:21-53``): ``n_stages`` bilinear downscalings by
``multiplier`` (no antialiasing, half-pixel centres, as ``jax.image.resize``
with ``antialias=False``), then an optional 1x1 ``channel_mapper`` conv
without bias. LBBDM's ``condition_key: SpatialRescaler`` context."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from bbdm_tpu_torch.models.layers import conv1x1


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
