"""The VQGAN perceptual term in the port (``models/gan_losses.py``,
``training/gan.py``, ``runners/vqgan.py``) against the JAX package's, on the CPU.

LPIPS-VGG with random weights (torch's default init, non-negative heads); the
JAX side gets the same weights through ``convert_lpips_state_dict``. The tiny
VQGAN and PatchGAN (the port's seeded initial weights on both sides), batches
and bars are those of ``test_torch_vqgan_step.py``: losses and d_weight 1e-4 relative, gradients 1e-5
absolute plus 1e-3 relative, four steps under its Adam bar. The LPIPS network
is frozen: no gradient reaches it, no optimizer holds it and no checkpoint
carries it; ``main_torch.py --train`` runs a cut copy of
``configs/Template-VQGAN-f4.yaml`` with ``lpips_weights`` set.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from test_torch_eval_metrics import random_lpips
from test_torch_train_step import assert_trees_close, assert_weights_close
from test_torch_vqgan_model import nchw, nhwc
from test_torch_vqgan_model import vq_params
from test_torch_vqgan_step import LR, SIZE, batch, grads_close, loss_config, models

import main_torch
from bbdm_tpu.config import dict2namespace
from bbdm_tpu.evaluation.lpips import convert_lpips_state_dict
from bbdm_tpu.models import gan_losses as jl
from bbdm_tpu.training.gan import GANTrainState as JaxGANState
from bbdm_tpu.training.gan import make_vqgan_losses as jax_losses
from bbdm_tpu.training.gan import make_vqgan_train_step as jax_train_step
from bbdm_tpu_torch.checkpoints import io
from bbdm_tpu_torch.checkpoints.from_jax import (
    adam_state_from_jax,
    adam_state_to_jax,
    jax_tree_from_state_dict,
    load_module_trees,
    module_trees_to_jax,
    state_dict_from_jax,
)
from bbdm_tpu_torch.config import dict2namespace as port_namespace
from bbdm_tpu_torch.config import apply_cli_overrides, load_config, save_config
from bbdm_tpu_torch.models import gan_losses as pl
from bbdm_tpu_torch.runners.vqgan import VQGANRunner
from bbdm_tpu_torch.training.gan import GANTrainState, make_vqgan_losses, make_vqgan_train_step
from bbdm_tpu_torch.training.optim import Optimizer
from bbdm_tpu_torch.utils.images import write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def init():
    """The tiny VQGAN (nearest quantizer) and PatchGAN of
    ``test_torch_vqgan_step.py`` with the port's seeded initial weights, as the
    JAX trees its ``models`` loads (flax ``init`` would cost ~20 s of CPU)."""
    from bbdm_tpu_torch.models.discriminator import NLayerDiscriminator
    from bbdm_tpu_torch.models.layers import init_parameters
    from bbdm_tpu_torch.models.vqgan import VQModel

    g = torch.Generator().manual_seed(0)
    vq = VQModel.from_config(vq_params("nearest", ch=64, size=SIZE), device="cpu")
    disc = NLayerDiscriminator(3, ndf=8, n_layers=2, device="cpu")
    init_parameters(vq, g)
    init_parameters(disc, g)
    params, stats = module_trees_to_jax(disc)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"nearest": host(jax_tree_from_state_dict(vq)), "disc": host(params),
            "stats": host(stats)}


@pytest.fixture(scope="module")
def vgg():
    """(the port's LPIPS-VGG, the JAX tree of its weights)."""
    m = random_lpips("vgg", seed=11)
    return m, convert_lpips_state_dict(m.state_dict(), "vgg")


def test_reconstruction_loss_with_lpips_vgg_matches_jax(vgg):
    """|x - xrec| + w * LPIPS-VGG(x, xrec) per element, and the gradient of its
    mean with respect to xrec."""
    model, tree = vgg
    rs = np.random.RandomState(4)
    x, xr = (rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    f = lambda r: jl.reconstruction_loss(jnp.asarray(x), r, lpips_params=tree,
                                         perceptual_weight=0.7)
    want, want_grad = (np.asarray(a) for a in jax.jit(
        lambda r: (f(r), jax.grad(lambda r: f(r).mean())(r)))(jnp.asarray(xr)))
    xr_t = nchw(xr).requires_grad_(True)
    got = pl.reconstruction_loss(nchw(x), xr_t, lpips=model, perceptual_weight=0.7)
    (grad,) = torch.autograd.grad(got.mean(), xr_t)
    np.testing.assert_allclose(nhwc(got.detach()), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nhwc(grad), want_grad, rtol=1e-3, atol=1e-9)
    assert float(np.abs(want - np.abs(x - xr)).min()) > 0  # the term is there


def test_gen_loss_with_the_perceptual_term_matches(init, vgg):
    """The generator loss (nll with LPIPS in it, also in the adaptive
    d_weight's nll gradient) and its gradient leaf by leaf."""
    model, tree = vgg
    cfg = loss_config()
    jvq, jdisc, vq, disc = models(init, "nearest")
    jgen, _ = jax_losses(jvq, jdisc, dict2namespace(cfg), lpips_params=tree)
    gen, _ = make_vqgan_losses(vq, disc, port_namespace(cfg), lpips=model)
    x, step = batch(1), 4
    (jt, aux), jg = jax.jit(jax.value_and_grad(jgen, has_aux=True))(
        init["nearest"], init["disc"], init["stats"], x, jnp.asarray(step))
    total, paux = gen(nchw(x), step)
    params = dict(vq.named_parameters())
    g = torch.autograd.grad(total, list(params.values()))
    for k in ("nll", "g_loss", "q_loss", "d_weight"):
        np.testing.assert_allclose(float(torch.as_tensor(paux[k]).detach()), float(aux[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jt), rtol=1e-4)
    grads_close(dict(zip(params, g)), jg, params)
    plain, _ = make_vqgan_losses(vq, disc, port_namespace(cfg))
    assert float(paux["nll"].detach()) > float(plain(nchw(x), step)[1]["nll"].detach()) + 1e-3


def test_gan_steps_with_the_perceptual_term_match(init, vgg):
    """Four steps with ``perceptual_weight`` 1.0 against ``make_vqgan_train_step``
    given ``lpips_params``, each from the JAX step's state before it (weights,
    Adam moments, BatchNorm statistics): Adam turns rounding in gradients that
    cancel to ~0 into lr-sized steps (``assert_weights_close``), and through
    the LPIPS gradient such outliers of one step move the next step's d_weight
    by ~2e-4, so each step is held from the same state: its metrics within
    1e-4 relative, the weights and moments after it under one step's Adam bar.
    The LPIPS weights do not move and get no gradient."""
    model, tree = vgg
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = loss_config()
    assert cfg["perceptual_weight"] == 1.0
    jvq, jdisc, vq, disc = models(init, "nearest")
    gen_tx, disc_tx = optax.adam(LR, b1=0.5, b2=0.9), optax.adam(LR, b1=0.5, b2=0.9)
    jstate = JaxGANState(step=jnp.asarray(0, jnp.int32), gen_params=init["nearest"],
                         disc_params=init["disc"], gen_opt=gen_tx.init(init["nearest"]),
                         disc_opt=disc_tx.init(init["disc"]), disc_stats=init["stats"])
    jstep = jax.jit(jax_train_step(jvq, jdisc, gen_tx, disc_tx, dict2namespace(cfg),
                                   lpips_params=tree))
    gp, dp = dict(vq.named_parameters()), dict(disc.named_parameters())
    adam = port_namespace({"optimizer": "Adam", "beta1": 0.5})
    state = GANTrainState(step=0, gen_params=gp, disc_params=dp,
                          gen_opt=Optimizer(adam, gp, b2=0.9),
                          disc_opt=Optimizer(adam, dp, b2=0.9), lr=torch.tensor(LR))
    step = make_vqgan_train_step(vq, disc, port_namespace(cfg), lpips=model)
    host = lambda t: jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(t))
    for i in range(4):
        x, key = batch(10 + i), jax.random.PRNGKey(20 + i)
        jstate, jm = jstep(jstate, x, key)
        m = step(state, nchw(x))
        assert state.step == int(jstate.step) == i + 1
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i + 1} {k}")
        assert_weights_close(jax_tree_from_state_dict(vq), jstate.gen_params, LR, 2 * LR)
        dtree, stats = module_trees_to_jax(disc)
        assert_weights_close(dtree, jstate.disc_params, LR, 2 * LR)
        assert_trees_close(stats, host(jstate.disc_stats), 1e-5, 1e-5, "disc_stats")
        for ours, theirs in ((state.gen_opt, jstate.gen_opt), (state.disc_opt, jstate.disc_opt)):
            assert_trees_close(adam_state_to_jax(ours), host(theirs), 1e-4, 2e-4, "adam")
            adam_state_from_jax(host(theirs), ours)
        with torch.no_grad():
            vq.load_state_dict(state_dict_from_jax(host(jstate.gen_params), vq))
        load_module_trees(disc, host(jstate.disc_params), host(jstate.disc_stats))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    assert all(p.grad is None for p in model.parameters())


# ------------------------------------------------------------------ runner

@pytest.fixture(scope="module")
def template_copy(tmp_path_factory):
    """``configs/Template-VQGAN-f4.yaml`` cut to ch 32 x (1, 2), one res block,
    16^2 images (4 train, 2 val, 2 test), n_embed 32, PatchGAN ndf 8 x 2,
    ``disc_start`` 0 and ``lpips_weights`` set (random LPIPS-VGG, ``.pth``)."""
    root = tmp_path_factory.mktemp("vq_lpips")
    rs = np.random.RandomState(0)
    for stage, n in (("train", 4), ("val", 2), ("test", 2)):
        os.makedirs(root / "data" / stage)
        for i in range(n):
            write_png(str(root / "data" / stage / f"im{i}.png"),
                      rs.randint(0, 256, (16, 16, 3)).astype(np.uint8))
    torch.save(random_lpips("vgg", seed=12).state_dict(), str(root / "lpips_vgg.pth"))
    cfg = load_config(os.path.join(REPO, "configs", "Template-VQGAN-f4.yaml"))
    assert cfg.model.loss.perceptual_weight == 1.0
    cfg.data.dataset_config.dataset_path = str(root / "data")
    cfg.data.dataset_config.image_size = 16
    cfg.data.dataset_config.flip = False
    for split in ("train", "val", "test"):
        cfg.data[split].batch_size = 2
    params = cfg.model.VQGAN.params
    params.n_embed = 32
    params.ddconfig.resolution, params.ddconfig.ch = 16, 32
    params.ddconfig.ch_mult, params.ddconfig.num_res_blocks = (1, 2), 1
    loss = cfg.model.loss
    loss.disc_start, loss.disc_ndf, loss.disc_num_layers = 0, 8, 2
    loss.lpips_weights = str(root / "lpips_vgg.pth")
    t = cfg.training
    t.save_interval = t.sample_interval = t.validation_interval = 1
    save_config(cfg, str(root / "vq.yaml"))
    return root


def test_the_lpips_network_is_frozen_and_on_the_runners_device(template_copy, monkeypatch):
    """The runner loads LPIPS-VGG from ``lpips_weights`` onto its device with the
    JAX runner's log line; one step moves the autoencoder but no LPIPS weight
    (none gets a gradient), no optimizer holds one, and the checkpoint trees
    are those of a run without LPIPS."""
    from bbdm_tpu_torch.evaluation import lpips as plp

    loaded, load = [], plp.load_lpips
    monkeypatch.setattr(plp, "load_lpips", lambda *a, **k: loaded.append(load(*a, **k))
                        or loaded[-1])
    path = str(template_copy / "vq.yaml")
    runner = VQGANRunner(apply_cli_overrides(load_config(path), main_torch.parse_args(
        ["-c", path, "--train", "--gpu_ids", "-1", "-r", str(template_copy / "r")])))
    logged = []
    runner.logger = logged.append
    step = runner.build_train_step()
    lpips_path = runner.config.model.loss.lpips_weights
    assert f"perceptual loss enabled (LPIPS weights: {lpips_path})" in logged
    (lp,) = loaded
    assert lp.net_name == "vgg" and lp.shift.device == runner.device and not lp.training
    lp_before = {k: v.clone() for k, v in lp.state_dict().items()}
    runner.model.train()
    x = runner._put_batch({"x": np.random.RandomState(1).uniform(
        -1, 1, (2, 16, 16, 3)).astype(np.float32)})[0]
    w = runner.model.vqgan.decoder.conv_out.weight.detach().clone()
    step(runner.state, x, x, runner.train_generator)
    assert not torch.equal(runner.model.vqgan.decoder.conv_out.weight, w)
    assert all(p.grad is None and not p.requires_grad for p in lp.parameters())
    for k, v in lp.state_dict().items():
        torch.testing.assert_close(v, lp_before[k], rtol=0, atol=0, msg=k)
    held = {id(p) for p in list(runner.state.gen_params.values())
            + list(runner.state.disc_params.values())}
    assert not any(id(p) in held for p in lp.parameters())
    model_states, optim_states = runner.get_checkpoint_states()
    assert sorted(model_states["model"]) == ["disc_stats", "discriminator", "vqgan"]
    assert len(optim_states["optimizer"]) == 2


def test_main_torch_trains_the_template_with_lpips_weights(template_copy, capsys):
    """``main_torch.py --train`` on the template copy with ``lpips_weights`` set
    (the JAX runner adds LPIPS there; the port refused it before) runs an epoch,
    validates, samples and saves; its checkpoint holds no LPIPS weight."""
    out = template_copy / "results"
    runner = main_torch.main(["-c", str(template_copy / "vq.yaml"), "--train", "--gpu_ids",
                              "-1", "-r", str(out), "--max_epoch", "1"])
    assert "perceptual loss enabled" in capsys.readouterr().out
    assert runner.global_step == 2
    ck = io.load_checkpoint(os.path.join(runner.config.result.ckpt_path, "last_model.ckpt"))
    assert sorted(ck["model"]) == ["disc_stats", "discriminator", "vqgan"]
