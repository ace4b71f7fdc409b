"""Brownian Bridge Diffusion Model, sampling path (port of ``bbdm_tpu/models/bridge.py``).

The reverse sampler is a Python loop over the precomputed per-step
coefficients (``models/schedules.py``): one UNet forward and one linear update
per step, starting from x_T := y (no prior draw). Once per call, not per step:
the subpixel phase kernels of every ``UpsampleConv3x3`` are combined, and the
UNet's >=2-D weights are cast to the compute dtype (1-D params, GroupNorm
scale/bias and conv biases, stay fp32).

Objectives: grad (x0 = x_t - pred), noise, ysubx.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call

from bbdm_tpu_torch.models.layers import UpsampleConv3x3
from bbdm_tpu_torch.models.schedules import (
    make_bridge_schedule,
    make_sampler_coeffs,
    make_sampling_steps,
)
from bbdm_tpu_torch.models.unet import UNet
from bbdm_tpu_torch.ops.upsample_conv import combine_kernel_2x2


class BrownianBridgeModel(nn.Module):
    """Pixel-space BBDM; ``model_config`` is the YAML ``model:`` subtree."""

    def __init__(self, model_config, *, dtype=torch.bfloat16, device=None):
        super().__init__()
        bb = model_config.BB.params
        self.num_timesteps = bb.num_timesteps
        self.objective = bb.objective
        if bb.get("sampler", "euler") != "euler":
            raise NotImplementedError("only the euler sampler is ported")
        self.condition_key = bb.UNetParams.condition_key
        self.dtype = dtype

        self.schedule = make_bridge_schedule(self.num_timesteps, bb.mt_type,
                                             bb.get("max_var", 1.0))
        self.steps = make_sampling_steps(self.num_timesteps, bb.skip_sample,
                                         bb.sample_type, bb.sample_step)
        self.coeffs = make_sampler_coeffs(self.num_timesteps, bb.mt_type,
                                          bb.get("max_var", 1.0), self.steps,
                                          bb.get("eta", 1.0))
        self.unet = UNet.from_config(bb.UNetParams, self.condition_key, dtype=dtype,
                                     init_scheme=model_config.get("init_scheme", "reference"),
                                     device=device)

    def predict_x0_from_objective(self, x_t, y, pred, *, m_t, sigma_t):
        if self.objective == "grad":
            return x_t - pred
        if self.objective == "noise":
            return (x_t - m_t * y - sigma_t * pred) / (1.0 - m_t)
        if self.objective == "ysubx":
            return y - pred
        raise NotImplementedError(self.objective)

    def _sampling_params(self) -> dict:
        """The UNet's parameters for one sampling call: >=2-D weights in the
        compute dtype, 1-D parameters fp32."""
        params = dict(self.unet.named_parameters())
        if self.dtype == torch.float32:
            return params
        return {k: p.to(self.dtype) if p.ndim >= 2 else p for k, p in params.items()}

    @contextlib.contextmanager
    def _hoisted_subpixel(self):
        """Give every UpsampleConv3x3 its combined phase kernel for this call."""
        mods = [m for m in self.unet.modules() if isinstance(m, UpsampleConv3x3)]
        for m in mods:
            m.combined = combine_kernel_2x2(m.weight).to(m.dtype or m.weight.dtype)
        try:
            yield
        finally:
            for m in mods:
                m.combined = None

    @torch.inference_mode()
    def p_sample_loop(self, y, context=None, *, clip_denoised=True,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Sequence[torch.Tensor]] = None):
        """Reverse skip-step sampler from x_T := y.

        ``noise``: one tensor of y's shape per step (for tests that feed the
        JAX package's draws); by default each step draws from ``generator``.
        """
        if self.condition_key == "nocond":
            context = None
        elif context is None:
            context = y
        c = self.coeffs
        if noise is not None and len(noise) != len(c.steps):
            raise ValueError(f"need {len(c.steps)} noise tensors, got {len(noise)}")
        params = self._sampling_params()
        B = y.shape[0]
        x_t = y
        with self._hoisted_subpixel():
            for i in range(len(c.steps)):
                t = torch.full((B,), int(c.steps[i]), dtype=torch.int32, device=y.device)
                pred = functional_call(self.unet, params, (x_t, t, context)).to(y.dtype)
                x0_hat = self.predict_x0_from_objective(
                    x_t, y, pred, m_t=float(c.m_t[i]), sigma_t=float(c.sigma_fwd[i]))
                if clip_denoised:
                    x0_hat = x0_hat.clamp(-1.0, 1.0)
                eps = noise[i] if noise is not None else torch.randn(
                    x_t.shape, generator=generator, dtype=x_t.dtype, device=x_t.device)
                x_t = (float(c.a_xt[i]) * x_t + float(c.a_x0[i]) * x0_hat
                       + float(c.a_y[i]) * y + float(c.sigma[i]) * eps)
        return x_t
