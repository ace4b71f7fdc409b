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
params, GroupNorm scale/bias and conv biases, stay fp32).

A step's body (``_reverse_step``) takes its coefficients as a row of a
per-call table on the device. On the card the step is captured once per
input shape as a CUDA graph and replayed for every step (the host's launch
path would otherwise set the pace at small shapes); there the weights and
phase kernels of the call are copied into static ones that outlive it, with
the graphs' memory pools, until ``release_step_graphs``. The eager loop runs
the same body on the CPU and under a model axis.

Objectives: grad (x0 = x_t - pred), noise, ysubx.
"""

from __future__ import annotations

import collections
import contextlib
import functools
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
from bbdm_tpu_torch import ops
from bbdm_tpu_torch.ops.upsample_conv import combine_kernel_2x2
from bbdm_tpu_torch.parallel import collectives, mesh
from bbdm_tpu_torch.utils.spans import span

# the columns of a row of BrownianBridgeModel.coeff_table: the step's update
# coefficients, then the timestep, m_t, sigma_t and 1 / (1 - m_t) of the step's
# grid time (from _NOW on) and of the next one (from _NEXT on)
_A_XT, _A_X0, _A_Y, _SIGMA, _NOW, _NEXT = 0, 1, 2, 3, 4, 8
GRAPHS_KEPT = 2  # captured steps a model keeps: a test set's batch and its smaller last one


def _scaled(a, x):
    """``a * x`` for a coefficient tensor ``a``, in a's precision: a 16-bit x is
    multiplied in fp32, as a Python float multiplies it, and the product
    rounded to x's dtype (a 0-d fp32 tensor alone would be rounded to 16 bits)."""
    return a * x if x.dtype == a.dtype else (a * x.to(a.dtype)).to(x.dtype)


def _graph_steps(y) -> bool:
    """Whether ``p_sample_loop`` on ``y`` replays its steps as a captured CUDA
    graph: when y is on the card, no capture is running already, and the grid
    has no model axis (a model-parallel forward gathers over its group inside
    the step). Otherwise the steps run eagerly."""
    return (y.is_cuda and not torch.cuda.is_current_stream_capturing()
            and mesh.grid().model_size == 1)


class _StaticWeights:
    """The sampling weights at fixed addresses, which captured steps read: the
    UNet's parameters as ``_sampling_params`` gives them (>=2-D in the compute
    dtype, 1-D fp32) and each UpsampleConv3x3's combined phase kernel.
    :meth:`refresh` copies the module's current values in, so that training
    updates and EMA swaps between calls are seen."""

    def __init__(self, model: "BrownianBridgeModel"):
        live = dict(model.unet.named_parameters())
        self.params = {k: p.clone() if p is live[k] else p
                       for k, p in model._sampling_params().items()}
        self.combined = model._combined_kernels()

    def refresh(self, model: "BrownianBridgeModel") -> None:
        live = dict(model.unet.named_parameters())
        torch._foreach_copy_(list(self.params.values()), [live[k] for k in self.params])
        if self.combined:
            torch._foreach_copy_(self.combined, model._combined_kernels())


class _EagerStep:
    """The reverse step run op by op, ``body(x_t, y, context, row, eps) ->
    (x_next, x0)``: after ``load(y, context)`` each ``step(row, eps)``
    advances ``x`` by a step and leaves the step's estimate in ``x0``
    (the interface of :class:`_StepGraph`)."""

    def __init__(self, body):
        self.body = body

    def load(self, y, context) -> None:
        """Start a loop from x_T := y with ``context``."""
        self.y, self.context, self.x = y, context, y

    def __call__(self, row, eps) -> None:
        self.x, self.x0 = self.body(self.x, self.y, self.context, row, eps)


class _StepGraph:
    """One reverse step captured as a CUDA graph over static inputs, with the
    interface of :class:`_EagerStep`: a step copies its coefficients and
    noise in and replays the graph, which writes x_next back into the static
    ``x``.

    The body runs once first on a side stream (cuDNN's plans, the kernels'
    cached plans and lazy loads happen there, not in the capture). The
    counts of ``ops.REPLAYED_COUNTS`` (the kernels' launches, attention's
    calls and FLOPs per route) count a replay as the eager step: their gain
    over the capture is kept and added back at each replay, and what the
    warm-up and the capture added is taken off again."""

    def __init__(self, body, y, context, row):
        self.y, self.x = y.clone(), y.clone()
        self.context = None if context is None else context.clone()
        self.row, self.eps = row.clone(), torch.zeros_like(y)
        before = ops.read_counts()
        side, current = torch.cuda.Stream(y.device), torch.cuda.current_stream(y.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            body(self.x, self.y, self.context, self.row, self.eps)
        current.wait_stream(side)
        warm = ops.read_counts()
        self.graph = torch.cuda.CUDAGraph()
        # other threads (a loader, the PNG writer) may call CUDA meanwhile
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            x_next, self.x0 = body(self.x, self.y, self.context, self.row, self.eps)
            self.x.copy_(x_next)
        self.counts = [n - w for n, w in zip(ops.read_counts(), warm)]
        ops.write_counts(before)

    def load(self, y, context) -> None:
        self.y.copy_(y)
        self.x.copy_(y)
        if context is not None:
            self.context.copy_(context)

    def __call__(self, row, eps) -> None:
        self.eps.copy_(eps)
        self.row.copy_(row)
        with span("sampler.replay"):
            self.graph.replay()
        ops.write_counts(self.counts, add=True)


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
        self._step_graphs = collections.OrderedDict()  # key -> _StepGraph, oldest first
        self._static_weights = None  # the _StaticWeights the captured steps read
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

    def predict_x0_from_objective(self, x_t, y, pred, *, m_t, sigma_t, inv_1m=None):
        """x0 from the UNet's output ``pred``. ``inv_1m``, where given, is
        1 / (1 - m_t) with m_t, sigma_t as 0-d coefficient tensors (a
        :meth:`coeff_table` row): the sampler's 'noise' step multiplies by it."""
        if self.objective == "grad":
            return x_t - pred
        if self.objective == "noise":
            if inv_1m is None:
                return (x_t - m_t * y - sigma_t * pred) / (1.0 - m_t)
            return _scaled(inv_1m, x_t - _scaled(m_t, y) - _scaled(sigma_t, pred))
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

    def _combined_kernels(self) -> list:
        """Each UpsampleConv3x3's phase kernel in its compute dtype, in module order."""
        return [combine_kernel_2x2(m.weight).to(m.dtype or m.weight.dtype)
                for m in self.unet.modules() if isinstance(m, UpsampleConv3x3)]

    @contextlib.contextmanager
    def _sampling_mode(self, combined=None):
        """Eval mode (no dropout, the subpixel up-conv), as the JAX sampler runs
        the UNet with ``train=False``, and every UpsampleConv3x3 given its
        combined phase kernel for this call (``combined``, the static copies a
        captured step reads, or kernels combined here); the mode and the
        kernels are restored after it, so a sample in the middle of training
        leaves nothing behind for the next step."""
        mods = [m for m in self.unet.modules() if isinstance(m, UpsampleConv3x3)]
        with eval_mode(self):
            for m, k in zip(mods, self._combined_kernels() if combined is None else combined):
                m.combined = k
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

    def coeff_table(self, y: torch.Tensor) -> torch.Tensor:
        """The reverse steps' coefficients for one ``p_sample_loop`` on ``y``,
        read from ``self.coeffs`` at each call: [S, 12] on y's device, fp32
        (fp64 for an fp64 y), a row a step: the step's a_xt, a_x0, a_y and
        sigma, then from ``_NOW`` on its grid time's timestep, m_t, sigma_t
        and 1 / (1 - m_t), and from ``_NEXT`` on the same of the next grid
        time (heun's second forward; the last row repeats its own, which
        heun's terminal step takes). 1 / (1 - m_t) is taken in float64 and
        rounded: the card divides a tensor by a Python float so (it
        multiplies by that reciprocal), where the CPU divides (up to an ulp
        apart). One host-to-device copy, which does not wait for the card."""
        c = self.coeffs
        nxt = np.append(c.steps[1:], c.steps[-1]).astype(np.int64)
        m, sig = self.schedule.m_t, np.sqrt(self.schedule.variance_t)
        dtype = torch.promote_types(y.dtype, torch.float32)
        col = lambda a: torch.from_numpy(np.asarray(a, np.float64)).to(dtype)  # noqa: E731
        cols = [col(a) for a in (c.a_xt, c.a_x0, c.a_y, c.sigma)]
        for t, m_t, sigma_t in ((c.steps, c.m_t, c.sigma_fwd), (nxt, m[nxt], sig[nxt])):
            cols += [col(t), col(m_t), col(sigma_t), col(1.0 / (1.0 - np.asarray(m_t, np.float64)))]
        table = torch.stack(cols, dim=1)
        if y.is_cuda:
            return table.pin_memory().to(y.device, non_blocking=True)
        return table.to(y.device)

    def _predict(self, params, x, y, context, row, col, clip_denoised):
        """The UNet's x0 estimate at the grid time whose timestep, m_t, sigma_t
        and 1 / (1 - m_t) are the entries ``col`` .. ``col + 3`` of ``row`` (a
        :meth:`coeff_table` row)."""
        t, m_t, sigma_t, inv_1m = row[col:col + 4]
        pred = functional_call(self.unet, params, (x, t.expand(x.shape[0]), context))
        x0 = self.predict_x0_from_objective(x, y, pred.to(y.dtype), m_t=m_t, sigma_t=sigma_t,
                                            inv_1m=inv_1m)
        return x0.clamp(-1.0, 1.0) if clip_denoised else x0

    def _reverse_step(self, params, x_t, y, context, row, eps, *, clip_denoised):
        """One reverse step from ``x_t`` with the coefficients ``row`` of
        :meth:`coeff_table` and the noise ``eps``: (x_next, the step's x0
        estimate). Euler: one forward and the linear update. Heun: a proposal
        to the next grid time, a second forward there, and the update from x_t
        with the mean of the two estimates. It takes tensors only and reads
        no value back to the host: the eager loop calls it, a captured graph
        replays it."""
        def predict(x, col):
            return self._predict(params, x, y, context, row, col, clip_denoised)

        def update(x0, eps=None):
            x = _scaled(row[_A_XT], x_t) + _scaled(row[_A_X0], x0) + _scaled(row[_A_Y], y)
            return x if eps is None else x + _scaled(row[_SIGMA], eps)

        x0 = predict(x_t, _NOW)
        if self.sampler == "heun":
            x0_b = predict(update(x0), _NEXT)
            x0 = 0.5 * (x0 + x0_b)
        return update(x0, eps), x0

    def _step_graph(self, key, body, y, context, row) -> "_StepGraph":
        """The captured step of ``key``, captured now (in a ``sampler.capture``
        span) where the cache lacks it; the cache keeps the
        :data:`GRAPHS_KEPT` used last."""
        entry = self._step_graphs.pop(key, None)
        if entry is None:
            with span("sampler.capture"):
                entry = _StepGraph(body, y, context, row)
            while len(self._step_graphs) >= GRAPHS_KEPT:
                del self._step_graphs[next(iter(self._step_graphs))]
        self._step_graphs[key] = entry
        return entry

    def release_step_graphs(self) -> None:
        """Drop the captured steps, their memory pools and the static weights."""
        self._step_graphs.clear()
        self._static_weights = None

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

        Where :func:`_graph_steps` allows it (on the card), the step
        (:meth:`_reverse_step`) is captured once per shape as a CUDA graph
        and replayed for every step: the host copies the step's noise and
        coefficients into the graph's static inputs and launches the graph.
        The noise is drawn outside the graph, in the eager loop's order, and
        the weights are copied into the graph's static ones at each call.
        Heun's terminal step runs eagerly either way.
        """
        with span("sampler.loop"):
            y = y.contiguous()  # the kernels take NCHW-contiguous activations
            if self.condition_key == "nocond":
                context = None
            elif context is None:
                context = y
            if noise is not None and len(noise) != self.noised_steps():
                raise ValueError(f"need {self.noised_steps()} noise tensors, got {len(noise)}")
            table = self.coeff_table(y)
            heun = self.sampler == "heun"
            graphed = _graph_steps(y)

            def draw(i):
                if noise is not None:
                    return noise[i]
                return collectives.randn(y.shape, generator=generator, dtype=y.dtype,
                                         device=y.device)

            imgs, one_step = [], []  # the trajectory, kept under sample_mid_step only
            if graphed:
                if self._static_weights is None:
                    self._static_weights = _StaticWeights(self)
                self._static_weights.refresh(self)
                params, combined = self._static_weights.params, self._static_weights.combined
            else:
                params, combined = self._sampling_params(), None
            with self._sampling_mode(combined):
                body = functools.partial(self._reverse_step, params,
                                         clip_denoised=clip_denoised)
                if graphed:
                    key = (tuple(y.shape), y.dtype, y.device,
                           None if context is None else (tuple(context.shape), context.dtype),
                           self.sampler, clip_denoised, self.objective)
                    step = self._step_graph(key, body, y, context, table[0])
                else:
                    step = _EagerStep(body)
                step.load(y, context)
                for i in range(len(table) - heun):
                    with span("sampler.step"):
                        step(table[i], draw(i))
                        if sample_mid_step:
                            imgs.append(step.x.clone())
                            one_step.append(step.x0.clone())
                x_t = step.x.clone()  # a graph's static x is the next call's
                if heun:
                    with span("sampler.step"):
                        x_t = self._predict(params, x_t, y, context, table[-1], _NEXT,
                                            clip_denoised)
                        if sample_mid_step:
                            imgs.append(x_t)
                            one_step.append(x_t)
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
