"""The VQGAN adversarial train step (port of ``bbdm_tpu/training/gan.py``).

One call per batch updates both players, each with its own Adam:

  generator:     nll + d_weight * disc_factor * (-E[D(xrec)]) + codebook_weight * q_loss
                 with nll = mean(|x - xrec| + perceptual_weight * LPIPS-VGG(x, xrec))
  discriminator: hinge or vanilla on D(x), D(xrec.detach())

The generator term runs the discriminator on its running statistics; its
gradient is taken with respect to the generator's parameters only (the
adversarial term also reaches the discriminator's, which must not move with
it). The adaptive d_weight takes the gradients of nll and of g with respect to
``decoder.conv_out.weight`` on the one forward graph (the JAX package
differentiates two more forwards), detached. The discriminator term runs
two train-mode forwards whose BatchNorm statistics move in sequence, with the
parameters from before this step. Before ``disc_start`` everything is computed
and the adversarial terms are scaled by 0, as ``jnp.where`` does there.

The Gumbel temperature is max(temp_min, temp_init * exp(-anneal_rate * step))
at the step being taken (the counter plus one), in fp32.

Data parallel (``parallel/``), as the JAX step under a data-parallel mesh: the
two last-layer gradients d_weight divides are averaged over ranks before their
norms, the discriminator's train-mode BatchNorm takes global statistics
(``models/discriminator.py``), both players' gradients are averaged over ranks
in one flat collective, and the returned losses are means over ranks (all
over the data group of the grid, ``parallel/mesh.py``).

Sharded (``state.sharding``, ``parallel/sharding.py``): both players' losses
and gradients are taken on the step form of the leaves, each gradient is
reduce-scattered over the data group to its shard, and the optimizers update
the shards. A decoder whose last layer is split over the model axis would need
d_weight's norms summed over the model group: it raises.

``debug_nan``: the step raises FloatingPointError at the first non-finite
global loss or averaged gradient, naming the step.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch

from bbdm_tpu_torch.models.gan_losses import (
    adaptive_d_weight,
    adopt_weight,
    hinge_d_loss,
    reconstruction_loss,
    vanilla_d_loss,
)
from bbdm_tpu_torch.parallel import collectives
from bbdm_tpu_torch.parallel import tensor as tp
from bbdm_tpu_torch.training.optim import Optimizer
from bbdm_tpu_torch.training.step import _check_finite


@dataclass
class GANTrainState:
    step: int  # batches taken
    gen_params: dict  # {name: parameter} of the VQ autoencoder
    disc_params: dict  # {name: parameter} of the discriminator
    gen_opt: Optimizer
    disc_opt: Optimizer
    lr: torch.Tensor  # 0-d fp32 on the device, both players' learning rate
    sharding: Optional[object] = None  # parallel.sharding.ShardedState, when sharded


def make_vqgan_losses(vq_model, disc_model, loss_config, *, lpips=None):
    """``(gen_loss, disc_loss)``; ``lpips``: the frozen LPIPS-VGG network of the
    perceptual term (``evaluation.lpips.LPIPS``) or None:

    * ``gen_loss(x, step, *, temp=1.0, u=None, generator=None) -> (total, aux)``
      with aux ``xrec``, ``nll``, ``g_loss``, ``q_loss``, ``d_weight``; ``u`` and
      ``generator`` reach the Gumbel quantizer;
    * ``disc_loss(x, xrec, step) -> loss``, moving the BatchNorm statistics.
    """
    is_gumbel = getattr(vq_model, "quantizer_type", "nearest") == "gumbel"
    disc_start = loss_config.get("disc_start", 0)
    disc_factor_cfg = loss_config.get("disc_factor", 1.0)
    disc_weight = loss_config.get("disc_weight", 1.0)
    codebook_weight = loss_config.get("codebook_weight", 1.0)
    perceptual_weight = loss_config.get("perceptual_weight", 1.0)
    adaptive = loss_config.get("adaptive_disc_weight", True)
    d_loss_fn = hinge_d_loss if loss_config.get("disc_loss", "hinge") == "hinge" \
        else vanilla_d_loss

    def factor(step, device):
        # fp32, as the JAX jnp.where gives it
        return torch.tensor(adopt_weight(disc_factor_cfg, step, disc_start),
                            dtype=torch.float32, device=device)

    def gen_loss(x, step, *, temp=1.0, u=None, generator=None):
        disc_factor = factor(step, x.device)
        xrec, qloss = vq_model(x, temp=temp, train=is_gumbel, u=u, generator=generator)
        nll = reconstruction_loss(x, xrec, lpips=lpips,
                                  perceptual_weight=perceptual_weight).mean()
        g = -disc_model(xrec, train=False).mean()
        if adaptive:
            w_last = vq_model.decoder.conv_out.weight
            if tp.is_shard(w_last, vq_model.decoder.conv_out.out_ch):
                raise NotImplementedError(
                    "the adaptive d_weight of a decoder whose last layer is split over the "
                    "model axis (model_parallel dividing its output channels)")
            nll_grad, = torch.autograd.grad(nll, w_last, retain_graph=True)
            g_grad, = torch.autograd.grad(g, w_last, retain_graph=True)
            collectives.all_reduce_mean_([nll_grad, g_grad])
            d_weight = adaptive_d_weight(nll_grad, g_grad, disc_weight).detach()
        else:
            d_weight = disc_weight
        total = nll + d_weight * disc_factor * g + codebook_weight * qloss
        return total, {"xrec": xrec, "nll": nll, "g_loss": g, "q_loss": qloss,
                       "d_weight": d_weight}

    def disc_loss(x, xrec, step):
        logits_real = disc_model(x, train=True)
        logits_fake = disc_model(xrec, train=True)
        return factor(step, x.device) * d_loss_fn(logits_real, logits_fake)

    return gen_loss, disc_loss


def gumbel_temperature(loss_config, step: int) -> float:
    """max(t_min, t_init * exp(-rate * step)) in fp32 (1 without a scheduler)."""
    cfg = loss_config.get("temperature_scheduler", None)
    t_init = cfg.get("temp_init", 1.0) if cfg is not None else 1.0
    t_min = cfg.get("temp_min", 0.5) if cfg is not None else 1.0
    t_rate = cfg.get("anneal_rate", 1e-5) if cfg is not None else 0.0
    s = torch.tensor(float(step), dtype=torch.float32)
    return float(torch.clamp_min(t_init * torch.exp(-t_rate * s), t_min))


def _grads(loss, params: dict, who: str):
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    missing = [k for k, g in zip(params, grads) if g is None]
    if missing:
        raise RuntimeError(f"no gradient reached {len(missing)} {who} parameters "
                           f"(first: {missing[0]}): the graph was cut")
    return list(grads)


def make_vqgan_train_step(vq_model, disc_model, loss_config, *, lpips=None, debug_nan=False):
    """``train_step(state, x, generator=None, *, u=None) -> metrics`` (0-d
    tensors: loss, d_loss, nll, g_loss, q_loss, d_weight, and temperature for
    the Gumbel quantizer), updating ``state`` in place. ``u``: the Gumbel
    uniforms (tests feed the JAX draws)."""
    is_gumbel = getattr(vq_model, "quantizer_type", "nearest") == "gumbel"
    gen_loss_fn, disc_loss_fn = make_vqgan_losses(vq_model, disc_model, loss_config,
                                                  lpips=lpips)

    def train_step(state: GANTrainState, x, generator=None, *, u=None):
        step = state.step + 1
        temp = gumbel_temperature(loss_config, step)
        sharding = state.sharding
        with sharding.step_form() if sharding is not None else contextlib.nullcontext():
            g_total, aux = gen_loss_fn(x, step, temp=temp, u=u, generator=generator)
            g_grads = _grads(g_total, state.gen_params, "generator")
            d_total = disc_loss_fn(x, aux["xrec"].detach(), step)
            d_grads = _grads(d_total, state.disc_params, "discriminator")
            grads = g_grads + d_grads
            if sharding is not None:
                grads = sharding.reduce([*state.gen_params.values(),
                                         *state.disc_params.values()], grads)
            else:
                collectives.all_reduce_mean_(grads)
        losses = collectives.mean(torch.stack([
            g_total.detach(), d_total.detach(), aux["nll"].detach(),
            aux["g_loss"].detach(), aux["q_loss"].detach()]))
        if debug_nan:
            _check_finite(step, "loss", [losses])
            _check_finite(step, "averaged gradient", grads)
        g_grads, d_grads = grads[:len(g_grads)], grads[len(g_grads):]
        state.gen_opt.update(g_grads, state.lr)
        state.disc_opt.update(d_grads, state.lr)
        state.step = step
        d_weight = aux["d_weight"]
        metrics = dict(zip(("loss", "d_loss", "nll", "g_loss", "q_loss"), losses.unbind(0)))
        metrics["d_weight"] = d_weight if torch.is_tensor(d_weight) \
            else torch.tensor(d_weight, dtype=torch.float32, device=x.device)
        if is_gumbel:
            metrics["temperature"] = torch.tensor(temp, dtype=torch.float32)
        return metrics

    return train_step
