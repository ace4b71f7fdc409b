"""Latent BBDM: the bridge in the latent space of a frozen VQGAN
(port of ``bbdm_tpu/models/latent.py``).

encode: VQGAN encoder [+ quant_conv unless latent_before_quant_conv], optional
per-channel normalisation; decode: denormalise, [quant_conv], quantise,
post_quant_conv + decoder. Latent statistics are [1, C, 1, 1] tensors. The
UNet's context is none (``nocond``), the condition's latent
(``first_stage``) or ``cond_stage``, a :class:`SpatialRescaler` of the
condition image (``SpatialRescaler``).

The VQGAN is frozen: its parameters require no grad, it stays in eval mode,
and ``encode``/``decode`` run under ``torch.no_grad()`` (the JAX package's
``stop_gradient``). The cond stage trains with the UNet. Only the sampling
entry points (:meth:`sample`, ``p_sample_loop``) run under
``torch.inference_mode()``: an inference tensor cannot be saved for backward.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bbdm_tpu_torch.models.bridge import BrownianBridgeModel
from bbdm_tpu_torch.models.cond import SpatialRescaler
from bbdm_tpu_torch.models.vqgan import VQModel


def init_latent_stats(channels: int, device=None) -> dict:
    """Identity normalisation statistics (mean 0, std 1), shape [1, C, 1, 1]."""
    z = torch.zeros((1, channels, 1, 1), device=device)
    o = torch.ones((1, channels, 1, 1), device=device)
    return {"ori_latent_mean": z, "ori_latent_std": o,
            "cond_latent_mean": z, "cond_latent_std": o}


class LatentBrownianBridgeModel(BrownianBridgeModel):
    def __init__(self, model_config, *, dtype=torch.bfloat16, device=None):
        super().__init__(model_config, dtype=dtype, device=device)
        self.latent_before_quant_conv = model_config.get("latent_before_quant_conv", False)
        self.normalize_latent = model_config.get("normalize_latent", False)
        self.vqgan = VQModel.from_config(model_config.VQGAN.params, dtype=dtype, device=device)
        self.vqgan.requires_grad_(False)
        self.cond_stage = None
        if self.condition_key == "SpatialRescaler":
            self.cond_stage = SpatialRescaler.from_config(model_config.CondStageParams,
                                                          dtype=dtype, device=device)
        elif self.condition_key not in ("nocond", "first_stage"):
            raise NotImplementedError(f"condition_key {self.condition_key!r} is not ported")

    def train(self, mode: bool = True):
        """Training mode for the UNet and the cond stage; the VQGAN stays in eval mode."""
        super().train(mode)
        self.vqgan.eval()
        return self

    def trainable_parameters(self) -> dict:
        """The UNet and the cond stage; the VQGAN is frozen
        (``bbdm_tpu/models/latent.py:73-78``)."""
        return {k: p for k, p in self.named_parameters() if not k.startswith("vqgan.")}

    def _stats(self, z, latent_stats, cond):
        s = latent_stats if latent_stats is not None else init_latent_stats(z.shape[1], z.device)
        pre = "cond" if cond else "ori"
        return s[f"{pre}_latent_mean"], s[f"{pre}_latent_std"]

    @torch.no_grad()
    def encode(self, x, *, cond=True, normalize=None, latent_stats=None):
        """Image [B, 3, H, W] -> bridge latent."""
        normalize = self.normalize_latent if normalize is None else normalize
        x = x.contiguous()  # the kernels take NCHW-contiguous activations
        z = (self.vqgan.encode_pre_quant(x) if self.latent_before_quant_conv
             else self.vqgan.encode_latent(x))
        if normalize:
            mean, std = self._stats(z, latent_stats, cond)
            z = (z - mean) / std
        return z

    @torch.no_grad()
    def decode(self, z, *, cond=True, normalize=None, latent_stats=None):
        """Bridge latent -> image: denormalise, [quant_conv], quantise, decode."""
        normalize = self.normalize_latent if normalize is None else normalize
        if normalize:
            mean, std = self._stats(z, latent_stats, cond)
            z = z * std + mean
        if self.latent_before_quant_conv:
            z = self.vqgan.apply_quant_conv(z)
        quant, _, _ = self.vqgan.quantize_latent(z)
        return self.vqgan.decode_from_quant(quant)

    def sample_vqgan(self, x):
        """The VQGAN roundtrip (``bbdm_tpu/models/latent.py:173-176``): image
        [B, 3, H, W] -> encode, quantize, decode (``VQModel.roundtrip``)."""
        return self.vqgan.roundtrip(x)

    def get_cond_stage_context(self, x_cond):
        """The UNet's context; the SpatialRescaler's keeps its graph (it trains)."""
        if self.condition_key == "SpatialRescaler":
            return self.cond_stage(x_cond.contiguous())
        if self.condition_key == "first_stage":
            return self.encode(x_cond, cond=True)
        return None

    def loss(self, x, y, context=None, *, latent_stats=None,
             generator: Optional[torch.Generator] = None, t=None, noise=None):
        """Training loss in latent space (``bbdm_tpu/models/latent.py:125-131``):
        x and y encoded without gradient, the context from the condition image."""
        x_latent = self.encode(x, cond=False, latent_stats=latent_stats)
        y_latent = self.encode(y, cond=True, latent_stats=latent_stats)
        if context is None:
            context = self.get_cond_stage_context(y)
        return super().loss(x_latent, y_latent, context, generator=generator, t=t, noise=noise)

    @torch.inference_mode()
    def sample(self, x_cond, context=None, *, clip_denoised=False, sample_mid_step=False,
               latent_stats=None, num_samples: int = 1,
               generator: Optional[torch.Generator] = None, noise: Optional[Sequence] = None):
        """Encode the condition once, run the reverse bridge from it, decode.

        ``num_samples > 1`` returns [num_samples, B, C, H, W], one decode per
        draw; ``noise`` is then one per-step noise sequence per draw.
        ``sample_mid_step`` returns both trajectories of ``p_sample_loop``
        decoded, each [S, B, C, H, W].
        """
        y_latent = self.encode(x_cond, cond=True, latent_stats=latent_stats)
        if context is None:
            context = self.get_cond_stage_context(x_cond)

        def loop(step_noise, mid=False):
            return self.p_sample_loop(y_latent, context, clip_denoised=clip_denoised,
                                      generator=generator, noise=step_noise,
                                      sample_mid_step=mid)

        def decode(z):
            return self.decode(z, cond=False, latent_stats=latent_stats)

        if num_samples > 1:
            if sample_mid_step:
                raise NotImplementedError("num_samples>1 with sample_mid_step")
            return torch.stack([decode(loop(None if noise is None else noise[i]))
                                for i in range(num_samples)])
        if sample_mid_step:
            return tuple(torch.stack([decode(z) for z in zs]) for zs in loop(noise, True))
        return decode(loop(noise))
