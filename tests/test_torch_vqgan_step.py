"""The port's VQGAN adversarial step (``training/gan.py``) against the JAX
package's ``make_vqgan_losses`` / ``make_vqgan_train_step``, on the CPU.

Both sides start from the JAX initial weights of a tiny VQGAN (ch 64 x (1, 2):
two channels per GroupNorm group, see test_torch_train_step.py) and a PatchGAN
of ndf 8 and 2 layers, get the same numpy batches and, for the Gumbel
quantizer, the JAX uniform draws (``u=``).

* The generator and discriminator losses, each against its JAX function
  (``disc_start`` 0, the adaptive d_weight on): the value and the gradient leaf
  by leaf; the discriminator's BatchNorm statistics after its two forwards.
* Four steps of the train step against ``make_vqgan_train_step``: the metrics,
  both players' parameters (the bar of test_torch_train_step.py for Adam's
  outliers), both Adam states and the BatchNorm statistics after every step.

Bars (fp32): losses and d_weight 1e-4 relative; gradients 1e-5 absolute plus
1e-3 relative (the adaptive weight divides two norms whose sums run in
another order); moments 2e-4 absolute plus 1e-4 relative; statistics 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from test_torch_train_step import assert_trees_close, assert_weights_close
from test_torch_vqgan_model import gumbel_draw, nchw, vq_params

from bbdm_tpu.config import dict2namespace
from bbdm_tpu.models.discriminator import NLayerDiscriminator as JaxDisc
from bbdm_tpu.models.vqgan import VQModel as JaxVQ
from bbdm_tpu.training.gan import GANTrainState as JaxGANState
from bbdm_tpu.training.gan import make_vqgan_losses as jax_losses
from bbdm_tpu.training.gan import make_vqgan_train_step as jax_train_step
from bbdm_tpu_torch.checkpoints.from_jax import (
    adam_state_to_jax,
    jax_tree_from_state_dict,
    load_module_trees,
    module_trees_to_jax,
    state_dict_from_jax,
)
from bbdm_tpu_torch.config import dict2namespace as port_namespace
from bbdm_tpu_torch.models.discriminator import NLayerDiscriminator
from bbdm_tpu_torch.models.vqgan import VQModel
from bbdm_tpu_torch.training.gan import (
    GANTrainState,
    make_vqgan_losses,
    make_vqgan_train_step,
)
from bbdm_tpu_torch.training.optim import Optimizer

SIZE, LR = 16, 1e-4
CASES = {
    "nearest-hinge": ("nearest", {"disc_loss": "hinge"}),
    "gumbel-vanilla": ("gumbel", {"disc_loss": "vanilla", "temperature_scheduler": {
        "temp_init": 1.0, "temp_min": 0.5, "anneal_rate": 0.1}}),
    "nearest-fixed-weight-gated": ("nearest", {"adaptive_disc_weight": False,
                                               "disc_start": 3}),
}


def loss_config(**over):
    d = {"disc_start": 0, "disc_factor": 1.0, "disc_weight": 0.8, "codebook_weight": 1.0,
         "perceptual_weight": 1.0, "disc_loss": "hinge", "adaptive_disc_weight": True,
         "use_actnorm": False}
    d.update(over)
    return d


@pytest.fixture(scope="module")
def init():
    """JAX initial variables of both tiny models, per quantizer."""
    x = np.zeros((1, SIZE, SIZE, 3), np.float32)
    out = {}
    for q in ("nearest", "gumbel"):
        jvq = JaxVQ.from_config(vq_params(q, ch=64, size=SIZE))
        out[q] = jax.tree_util.tree_map(np.asarray, jvq.init(jax.random.PRNGKey(0), x)["params"])
    d = JaxDisc(ndf=8, n_layers=2).init(jax.random.PRNGKey(1), x, train=False)
    out["disc"] = jax.tree_util.tree_map(np.asarray, d["params"])
    out["stats"] = jax.tree_util.tree_map(np.asarray, d["batch_stats"])
    return out


def models(init, quantizer):
    """(JAX vq, JAX disc, port vq in training mode, port disc) with equal weights."""
    jvq = JaxVQ.from_config(vq_params(quantizer, ch=64, size=SIZE))
    jdisc = JaxDisc(ndf=8, n_layers=2)
    vq = VQModel.from_config(vq_params(quantizer, ch=64, size=SIZE), device="cpu").train()
    vq.load_state_dict(state_dict_from_jax(init[quantizer], vq))
    disc = NLayerDiscriminator(3, ndf=8, n_layers=2, device="cpu").train()
    load_module_trees(disc, init["disc"], init["stats"])
    return jvq, jdisc, vq, disc


def batch(seed):
    return np.random.RandomState(seed).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)


def draws(jvq, params, key, quantizer):
    if quantizer != "gumbel":
        return None
    return nchw(gumbel_draw(jvq, params, key, lambda m: m.quantize, (2, SIZE // 2, SIZE // 2, 32)))


def grads_close(got: dict, want_tree, names):
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, want_tree), names)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_gen_and_disc_losses_match_make_vqgan_losses(init, case):
    quantizer, over = CASES[case]
    cfg = loss_config(**over)
    jvq, jdisc, vq, disc = models(init, quantizer)
    jgen, jdl = jax_losses(jvq, jdisc, dict2namespace(cfg))
    gen, dl = make_vqgan_losses(vq, disc, port_namespace(cfg))
    x, step, key = batch(1), 4, jax.random.PRNGKey(5)

    (jt, aux), jg = jax.value_and_grad(jgen, has_aux=True)(
        init[quantizer], init["disc"], init["stats"], x, jnp.asarray(step), temp=0.8, rng=key)
    total, paux = gen(nchw(x), step, temp=0.8, u=draws(jvq, init[quantizer], key, quantizer))
    params = dict(vq.named_parameters())
    g = torch.autograd.grad(total, list(params.values()))
    for k in ("nll", "g_loss", "q_loss", "d_weight"):
        np.testing.assert_allclose(float(torch.as_tensor(paux[k]).detach()), float(aux[k]),
                                   rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(total.item(), float(jt), rtol=1e-4)
    grads_close(dict(zip(params, g)), jg, params)

    xrec = np.asarray(aux["xrec"])
    (jd, jstats), jdg = jax.value_and_grad(jdl, has_aux=True)(
        init["disc"], init["stats"], x, xrec, jnp.asarray(step))
    dparams = dict(disc.named_parameters())
    d = dl(nchw(x), nchw(xrec), step)
    dg = torch.autograd.grad(d, list(dparams.values()))
    np.testing.assert_allclose(d.item(), float(jd), rtol=1e-4, atol=1e-7)
    grads_close(dict(zip(dparams, dg)), jdg, dparams)
    assert_trees_close(module_trees_to_jax(disc)[1], jax.tree_util.tree_map(np.asarray, jstats),
                       1e-5, 1e-5, "disc_stats")


@pytest.mark.parametrize("case", ["nearest-hinge", "gumbel-vanilla"])
def test_gan_steps_match_make_vqgan_train_step(init, case):
    quantizer, over = CASES[case]
    cfg = loss_config(**over)
    jvq, jdisc, vq, disc = models(init, quantizer)
    gen_tx, disc_tx = optax.adam(LR, b1=0.5, b2=0.9), optax.adam(LR, b1=0.5, b2=0.9)
    jstate = JaxGANState(step=jnp.asarray(0, jnp.int32), gen_params=init[quantizer],
                         disc_params=init["disc"], gen_opt=gen_tx.init(init[quantizer]),
                         disc_opt=disc_tx.init(init["disc"]), disc_stats=init["stats"])
    jstep = jax.jit(jax_train_step(jvq, jdisc, gen_tx, disc_tx, dict2namespace(cfg)))

    gp, dp = dict(vq.named_parameters()), dict(disc.named_parameters())
    adam = port_namespace({"optimizer": "Adam", "beta1": 0.5})
    state = GANTrainState(step=0, gen_params=gp, disc_params=dp,
                          gen_opt=Optimizer(adam, gp, b2=0.9),
                          disc_opt=Optimizer(adam, dp, b2=0.9), lr=torch.tensor(LR))
    step = make_vqgan_train_step(vq, disc, port_namespace(cfg))
    host = lambda t: jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(t))
    for i in range(4):
        x, key = batch(10 + i), jax.random.PRNGKey(20 + i)
        u = draws(jvq, jstate.gen_params, key, quantizer)
        jstate, jm = jstep(jstate, x, key)
        m = step(state, nchw(x), u=u)
        assert state.step == int(jstate.step) == i + 1
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i + 1} {k}")
        assert_weights_close(jax_tree_from_state_dict(vq), jstate.gen_params, LR, 2 * LR * (i + 1))
        dtree, stats = module_trees_to_jax(disc)
        assert_weights_close(dtree, jstate.disc_params, LR, 2 * LR * (i + 1))
        assert_trees_close(stats, host(jstate.disc_stats), 1e-5, 1e-5, "disc_stats")
        assert_trees_close(adam_state_to_jax(state.gen_opt), host(jstate.gen_opt), 1e-4, 2e-4,
                           "gen_opt")
        assert_trees_close(adam_state_to_jax(state.disc_opt), host(jstate.disc_opt), 1e-4, 2e-4,
                           "disc_opt")
