"""Brownian Bridge Diffusion Model (port of ``bbdm_tpu/models/bridge.py``).

Training: :meth:`BrownianBridgeModel.loss` draws t and the noise (from an
explicit generator, or takes them as ``t=`` / ``noise=``), forms x_t and the
objective with :meth:`q_sample` and runs the UNet in the module's mode (in
training mode with dropout and the naive up-conv, as the JAX loss runs it
with ``train=True``).

The reverse sampler is a Python loop over the precomputed per-step
coefficients (``models/schedules.py``), starting from x_T := y (no prior
draw). ``BB.params.sampler`` picks the update:

* ``euler`` (the reference's): one UNet forward and one linear update per step;
* ``heun`` (``bbdm_tpu/models/bridge.py:311-377``): a deterministic proposal
  to the next grid time, a second UNet forward there, and the step redone from
  x_t with the mean of the two x0 estimates; noise is added once, after the
  corrector. The terminal t = 0 entry takes a single forward and returns x0.

The sampler runs the UNet in eval mode, whatever the module's mode. Once per
call, not per step: the subpixel phase kernels of every ``UpsampleConv3x3``
are combined, and the UNet's >=2-D weights are cast to the compute dtype (1-D
params, GroupNorm scale/bias and conv biases, stay fp32); neither outlives
the call.

Objectives: grad (x0 = x_t - pred), noise, ysubx.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from bbdm_tpu_torch.models.layers import UpsampleConv3x3, eval_mode
from bbdm_tpu_torch.models.schedules import (
    make_bridge_schedule,
    make_sampler_coeffs,
    make_sampling_steps,
)
from bbdm_tpu_torch.models.unet import UNet
from bbdm_tpu_torch.ops.upsample_conv import combine_kernel_2x2
from bbdm_tpu_torch.parallel import collectives
from bbdm_tpu_torch.utils.spans import span


class BrownianBridgeModel(nn.Module):
    """Pixel-space BBDM; ``model_config`` is the YAML ``model:`` subtree."""

    def __init__(self, model_config, *, dtype=torch.bfloat16, device=None):
        super().__init__()
        bb = model_config.BB.params
        self.num_timesteps = bb.num_timesteps
        self.objective = bb.objective
        self.loss_type = bb.loss_type
        self.sampler = bb.get("sampler", "euler")
        if self.sampler not in ("euler", "heun"):
            raise NotImplementedError(f"sampler {self.sampler!r}")
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
        # the loss's schedule lookups, fp32 as jnp.asarray gives them to the JAX loss
        for name in ("m_t", "variance_t"):
            self.register_buffer(f"_{name}", torch.as_tensor(
                getattr(self.schedule, name), dtype=torch.float32, device=device),
                persistent=False)

    def trainable_parameters(self) -> dict:
        """{state_dict name: parameter} of what the optimizer trains (the JAX
        ``trainable_mask``): everything, for pixel BBDM."""
        return dict(self.named_parameters())

    def _m_sigma(self, t, ndim):
        """m_t and sigma_t of the per-example timesteps t, broadcast over ndim dims."""
        shape = (-1,) + (1,) * (ndim - 1)
        return self._m_t[t].reshape(shape), torch.sqrt(self._variance_t[t].reshape(shape))

    def q_sample(self, x0, y, t, noise):
        """Forward bridge draw and training objective (``bbdm_tpu/models/bridge.py:156-170``)."""
        m_t, sigma_t = self._m_sigma(t, x0.ndim)
        x_t = (1.0 - m_t) * x0 + m_t * y + sigma_t * noise
        if self.objective == "grad":
            objective = m_t * (y - x0) + sigma_t * noise
        elif self.objective == "noise":
            objective = noise
        elif self.objective == "ysubx":
            objective = y - x0
        else:
            raise NotImplementedError(self.objective)
        return x_t, objective

    def loss(self, x, y, context=None, *, generator: Optional[torch.Generator] = None,
             t=None, noise=None):
        """Training loss (``bbdm_tpu/models/bridge.py:187-223``): returns
        ``(loss, {"loss", "x0_recon"})``. t ~ U{0..T-1} and the noise are drawn
        from ``generator`` at the global batch's shape, this rank's rows kept
        (``parallel.collectives``), unless given (``t=`` [B] ints, ``noise=``
        x's shape), which lets tests feed the JAX package's draws."""
        x, y = x.contiguous(), y.contiguous()  # the kernels take NCHW-contiguous activations
        if self.condition_key == "nocond":
            context = None
        elif context is None:
            context = y
        B = x.shape[0]
        if t is None:
            t = collectives.randint(0, self.num_timesteps, (B,), generator=generator,
                                    device=x.device)
        if noise is None:
            noise = collectives.randn(x.shape, generator=generator, dtype=x.dtype,
                                      device=x.device)
        x_t, objective = self.q_sample(x, y, t, noise)
        pred = self.unet(x_t, t, context).to(x.dtype)
        if self.loss_type == "l1":
            recloss = (objective - pred).abs().mean()
        elif self.loss_type == "l2":
            recloss = ((objective - pred) ** 2).mean()
        else:
            raise NotImplementedError(self.loss_type)
        m_t, sigma_t = self._m_sigma(t, x.ndim)
        x0_recon = self.predict_x0_from_objective(x_t, y, pred, m_t=m_t, sigma_t=sigma_t)
        return recloss, {"loss": recloss, "x0_recon": x0_recon}

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
    def _sampling_mode(self):
        """Eval mode (no dropout, the subpixel up-conv), as the JAX sampler runs
        the UNet with ``train=False``, and every UpsampleConv3x3 given its
        combined phase kernel for this call; the mode and the kernels are
        restored after it, so a sample in the middle of training leaves
        nothing behind for the next step."""
        mods = [m for m in self.unet.modules() if isinstance(m, UpsampleConv3x3)]
        with eval_mode(self):
            for m in mods:
                m.combined = combine_kernel_2x2(m.weight).to(m.dtype or m.weight.dtype)
            try:
                yield
            finally:
                for m in mods:
                    m.combined = None

    @torch.inference_mode()
    def q_sample_loop(self, x0, y, *, generator: Optional[torch.Generator] = None,
                      noise=None):
        """The forward-bridge trajectory (``bbdm_tpu/models/bridge.py:227-238``):
        [T, B, C, H, W], entry t the :meth:`q_sample` draw of x_t at t, each t
        with fresh noise in x0's dtype, drawn from ``generator`` at the global
        batch's shape (this rank's rows kept) unless ``noise`` (T tensors of
        x0's shape, e.g. the JAX package's draws) is given. As in JAX, the
        fp32 schedule promotes a 16-bit x0 to an fp32 trajectory."""
        T, B = self.num_timesteps, x0.shape[0]
        if noise is not None and len(noise) != T:
            raise ValueError(f"need {T} noise tensors, got {len(noise)}")
        out = None
        for t in range(T):
            eps = (noise[t].to(x0.dtype) if noise is not None else
                   collectives.randn(x0.shape, generator=generator, dtype=x0.dtype,
                                     device=x0.device))
            tt = torch.full((B,), t, dtype=torch.long, device=x0.device)
            x_t, _ = self.q_sample(x0, y, tt, eps)
            if out is None:
                out = x_t.new_empty((T, *x_t.shape))
            out[t] = x_t
        return out

    def noised_steps(self) -> int:
        """How many noise tensors one ``p_sample_loop`` draws (its ``noise=`` length)."""
        return len(self.coeffs.steps) - (self.sampler == "heun")

    @torch.inference_mode()
    def p_sample_loop(self, y, context=None, *, clip_denoised=True,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Sequence[torch.Tensor]] = None,
                      sample_mid_step: bool = False):
        """Reverse skip-step sampler from x_T := y.

        ``noise``: :meth:`noised_steps` tensors of y's shape (for tests that
        feed the JAX package's draws); by default each noised step draws from
        ``generator`` at the global batch's shape and keeps this rank's rows.
        ``sample_mid_step`` returns the trajectory instead of its end:
        ``(imgs, one_step_imgs)``, each [S, B, C, H, W], the state after each
        step and that step's x0 estimate.
        """
        with span("sampler.loop"):
            y = y.contiguous()  # the kernels take NCHW-contiguous activations
            if self.condition_key == "nocond":
                context = None
            elif context is None:
                context = y
            c = self.coeffs
            if noise is not None and len(noise) != self.noised_steps():
                raise ValueError(f"need {self.noised_steps()} noise tensors, got {len(noise)}")
            params = self._sampling_params()
            B = y.shape[0]

            def predict(x, t, m_t, sigma_t):
                tt = torch.full((B,), int(t), dtype=torch.int32, device=y.device)
                pred = functional_call(self.unet, params, (x, tt, context)).to(y.dtype)
                x0 = self.predict_x0_from_objective(x, y, pred, m_t=float(m_t),
                                                    sigma_t=float(sigma_t))
                return x0.clamp(-1.0, 1.0) if clip_denoised else x0

            def draw(i):
                if noise is not None:
                    return noise[i]
                return collectives.randn(y.shape, generator=generator, dtype=y.dtype,
                                         device=y.device)

            def update(i, x_t, x0, eps=None):
                x = float(c.a_xt[i]) * x_t + float(c.a_x0[i]) * x0 + float(c.a_y[i]) * y
                return x if eps is None else x + float(c.sigma[i]) * eps

            imgs, one_step = [], []  # the trajectory, kept under sample_mid_step only

            def keep(x, x0):
                if sample_mid_step:
                    imgs.append(x)
                    one_step.append(x0)

            x_t = y
            with self._sampling_mode():
                if self.sampler == "euler":
                    for i in range(len(c.steps)):
                        with span("sampler.step"):
                            x0 = predict(x_t, c.steps[i], c.m_t[i], c.sigma_fwd[i])
                            x_t = update(i, x_t, x0, draw(i))
                            keep(x_t, x0)
                else:
                    m, sig = self.schedule.m_t, np.sqrt(self.schedule.variance_t)
                    for i in range(len(c.steps) - 1):
                        with span("sampler.step"):
                            nt = int(c.steps[i + 1])
                            x0_a = predict(x_t, c.steps[i], c.m_t[i], c.sigma_fwd[i])
                            x0_b = predict(update(i, x_t, x0_a), nt, m[nt], sig[nt])
                            x0 = 0.5 * (x0_a + x0_b)
                            x_t = update(i, x_t, x0, draw(i))
                            keep(x_t, x0)
                    last = int(c.steps[-1])
                    with span("sampler.step"):
                        x_t = predict(x_t, last, m[last], sig[last])
                        keep(x_t, x_t)
            if sample_mid_step:
                return torch.stack(imgs), torch.stack(one_step)
            return x_t

    @torch.inference_mode()
    def sample(self, x_cond, context=None, *, clip_denoised=True, sample_mid_step=False,
               num_samples: int = 1, generator: Optional[torch.Generator] = None,
               noise: Optional[Sequence] = None):
        """Pixel-space sampling from the condition image (``bbdm_tpu/models/bridge.py:379-397``).

        ``num_samples > 1`` returns [num_samples, B, C, H, W]; ``noise`` is then
        one per-step noise sequence per draw.
        """
        def draw(step_noise, mid=False):
            return self.p_sample_loop(x_cond, context, clip_denoised=clip_denoised,
                                      generator=generator, noise=step_noise,
                                      sample_mid_step=mid)

        if num_samples > 1:
            if sample_mid_step:
                raise NotImplementedError("num_samples>1 with sample_mid_step")
            return torch.stack([draw(None if noise is None else noise[i])
                                for i in range(num_samples)])
        return draw(noise, sample_mid_step)
