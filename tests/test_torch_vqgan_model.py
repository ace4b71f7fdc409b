"""The VQGAN training modules of the port against the JAX package, on the CPU:
the PatchGAN discriminator (BatchNorm in both modes and its running
statistics, ActNorm), the GAN loss functions, the nearest-neighbour quantizer's
loss and straight-through gradient, the Gumbel quantizer with the JAX uniform
draws fed in, and the autoencoder's training roundtrip ``VQModel.forward``.

Inputs come from numpy seeds; weights from the JAX initialisers, loaded into
the port through ``checkpoints/from_jax.py``. Bars (fp32, sums in another
order): 2e-5 absolute + 1e-4 relative for values of order 1; running
statistics 1e-6; the roundtrip 1e-4 (the port trains its up-convs through the
naive upsample + conv, the JAX step through the subpixel lowering: equal in
exact arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbdm_tpu.config import dict2namespace
from bbdm_tpu.models import discriminator as jd
from bbdm_tpu.models import gan_losses as jl
from bbdm_tpu.models import vqgan as jv
from bbdm_tpu_torch.checkpoints.from_jax import (
    load_module_trees,
    module_trees_to_jax,
    state_dict_from_jax,
)
from bbdm_tpu_torch.models import discriminator as pd
from bbdm_tpu_torch.models import gan_losses as pl
from bbdm_tpu_torch.models import vqgan as pv

ATOL, RTOL = 2e-5, 1e-4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def vq_params(quantizer="nearest", ch=32, size=16):
    """The tiny VQGAN of the parity tests: ch x (1, 2), one res block."""
    return dict2namespace({
        "embed_dim": 3, "n_embed": 32, "quantizer": quantizer, "kl_weight": 5e-3,
        "ddconfig": {"double_z": False, "z_channels": 3, "resolution": size,
                     "in_channels": 3, "out_ch": 3, "ch": ch, "ch_mult": (1, 2),
                     "num_res_blocks": 1, "attn_resolutions": [], "dropout": 0.0}})


# ------------------------------------------------------------ discriminator

@pytest.fixture(scope="module")
def disc_pair():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 32, 32, 3).astype(np.float32)
    jdisc = jd.NLayerDiscriminator(ndf=8, n_layers=2)
    variables = jax.tree_util.tree_map(np.asarray, jdisc.init(jax.random.PRNGKey(0), x))
    # move the statistics off their initial 0 / 1 once, so eval mode reads real ones
    _, upd = jdisc.apply(variables, rs.randn(2, 32, 32, 3).astype(np.float32) * 2 + 1,
                         train=True, mutable=["batch_stats"])
    variables = {"params": variables["params"],
                 "batch_stats": jax.tree_util.tree_map(np.asarray, upd["batch_stats"])}
    return jdisc, variables, x


def port_disc(variables, use_actnorm=False):
    disc = pd.NLayerDiscriminator(3, ndf=8, n_layers=2, use_actnorm=use_actnorm, device="cpu")
    load_module_trees(disc, variables["params"], variables.get("batch_stats"))
    return disc


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches_flax(disc_pair, train):
    """Both modes; in train mode also the BatchNorm running statistics after
    the call (flax ``mutable=["batch_stats"]``: momentum 0.9 on the old value,
    the biased batch variance)."""
    jdisc, variables, x = disc_pair
    disc = port_disc(variables)
    got = disc(nchw(x), train=train)
    if train:
        want, upd = jdisc.apply(variables, x, train=True, mutable=["batch_stats"])
        _, stats = module_trees_to_jax(disc)
        for name, node in upd["batch_stats"].items():
            for k in ("mean", "var"):
                close(stats[name][k], node[k], atol=1e-6, rtol=1e-5)
    else:
        want = jdisc.apply(variables, x, train=False)
        _, stats = module_trees_to_jax(disc)  # eval mode leaves them
        for name, node in variables["batch_stats"].items():
            for k in ("mean", "var"):
                np.testing.assert_array_equal(stats[name][k], node[k])
    assert got.shape == (2, 1, 6, 6)
    close(nhwc(got), want)


def test_discriminator_gradients_match_flax(disc_pair):
    """The gradient of a train-mode hinge loss through both forwards with
    respect to every discriminator parameter (the BatchNorm backward included)."""
    jdisc, variables, x = disc_pair
    fake = np.random.RandomState(1).randn(*x.shape).astype(np.float32)

    def loss(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        real, upd = jdisc.apply(v, x, train=True, mutable=["batch_stats"])
        v = {"params": params, "batch_stats": upd["batch_stats"]}
        fk, _ = jdisc.apply(v, fake, train=True, mutable=["batch_stats"])
        return jl.hinge_d_loss(real, fk)

    want_loss, want = jax.value_and_grad(loss)(variables["params"])
    disc = port_disc(variables)
    got_loss = pl.hinge_d_loss(disc(nchw(x), train=True), disc(nchw(fake), train=True))
    params = dict(disc.named_parameters())
    grads = torch.autograd.grad(got_loss, list(params.values()))
    close(got_loss.item(), float(want_loss))
    got = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, want), params)
    for (name, g) in zip(params, grads):
        close(g.numpy(), got[name].numpy(), atol=1e-5, rtol=1e-3)


def test_actnorm_matches_flax():
    """ActNorm with its data-dependent init (done by flax on a batch, carried
    over by the converter) in a discriminator, and alone."""
    rs = np.random.RandomState(2)
    x = (rs.randn(2, 32, 32, 3) * 3 + 1).astype(np.float32)
    jdisc = jd.NLayerDiscriminator(ndf=8, n_layers=2, use_actnorm=True)
    variables = jax.tree_util.tree_map(np.asarray, jdisc.init(jax.random.PRNGKey(1), x))
    assert "batch_stats" not in variables
    disc = port_disc(variables, use_actnorm=True)
    assert not list(disc.buffers())
    close(nhwc(disc(nchw(x))), jdisc.apply(variables, x))

    an = jd.ActNorm()
    v = jax.tree_util.tree_map(np.asarray, an.init(jax.random.PRNGKey(0), x))
    port = pd.ActNorm(3)
    load_module_trees(port, v["params"])
    close(nhwc(port(nchw(x))), an.apply(v, x))


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("fn", ["hinge_d_loss", "vanilla_d_loss"])
def test_disc_losses_match(fn):
    rs = np.random.RandomState(3)
    real, fake = (rs.randn(2, 4, 4, 1).astype(np.float32) * 2 for _ in range(2))
    close(getattr(pl, fn)(nchw(real), nchw(fake)).item(), getattr(jl, fn)(real, fake))


@pytest.mark.parametrize("step,threshold", [(10, 100), (100, 100), (200, 100)])
def test_adopt_weight_matches(step, threshold):
    assert np.float32(pl.adopt_weight(0.7, step, threshold)) == np.asarray(
        jl.adopt_weight(0.7, jnp.asarray(step), threshold))


def test_reconstruction_loss_and_adaptive_weight_match():
    rs = np.random.RandomState(4)
    x, xr = (rs.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    close(nhwc(pl.reconstruction_loss(nchw(x), nchw(xr), perceptual_weight=1.0)),
          jl.reconstruction_loss(x, xr, perceptual_weight=1.0))
    a, b = rs.randn(3, 3, 32, 3).astype(np.float32), rs.randn(3, 3, 32, 3).astype(np.float32)
    for scale in (1.0, 1e-9):  # 1e-9: the clip at 1e4
        close(pl.adaptive_d_weight(torch.from_numpy(a), torch.from_numpy(b * scale), 0.8).item(),
              jl.adaptive_d_weight(a, b * scale, 0.8))


def test_reconstruction_loss_refuses_the_perceptual_term():
    """The perceptual term is no longer refused: with an LPIPS-VGG network and
    ``perceptual_weight`` 0 the loss is |x - xrec| alone; with weight 1 it
    equals the JAX ``reconstruction_loss`` given the same weights (1e-5
    relative; ``test_torch_vqgan_perceptual.py`` holds its gradient and the GAN
    step)."""
    from test_torch_eval_metrics import random_lpips

    from bbdm_tpu.evaluation.lpips import convert_lpips_state_dict

    x = torch.zeros(1, 3, 16, 16)
    vgg = random_lpips("vgg")
    assert pl.reconstruction_loss(x, x, lpips=vgg, perceptual_weight=0.0).sum() == 0
    rs = np.random.RandomState(5)
    a, b = (rs.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        got = nhwc(pl.reconstruction_loss(nchw(a), nchw(b), lpips=vgg, perceptual_weight=1.0))
    want = jl.reconstruction_loss(a, b, lpips_params=convert_lpips_state_dict(
        vgg.state_dict(), "vgg"), perceptual_weight=1.0)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    assert (got > np.abs(a - b)).all()


# -------------------------------------------------------------- quantizers

def gumbel_draw(module, params, key, quantizer, shape):
    """The uniforms the JAX GumbelQuantize draws (NHWC ``shape``): its first
    ``make_rng("gumbel")`` in its own scope, called through ``apply``."""
    rng = module.apply({"params": params}, method=lambda m: quantizer(m).make_rng("gumbel"),
                       rngs={"gumbel": key})
    return jax.random.uniform(rng, shape, jnp.float32, minval=jnp.finfo(jnp.float32).tiny,
                              maxval=1.0)


def test_vector_quantizer_loss_and_gradient_match():
    """z_q, the commitment loss and the gradients of loss + <z_q, g> with
    respect to z (straight through) and the codebook."""
    rs = np.random.RandomState(5)
    z = (rs.randn(2, 4, 4, 3) * 0.05).astype(np.float32)
    gout = rs.randn(2, 4, 4, 3).astype(np.float32)
    jq = jv.VectorQuantizer(32, 3)
    params = jax.tree_util.tree_map(np.asarray, jq.init(jax.random.PRNGKey(0), z)["params"])

    def f(z, p):
        zq, loss, _ = jq.apply({"params": p}, z)
        return loss + jnp.sum(zq * gout), (zq, loss)

    (_, (zq, loss)), (gz, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(z, params)
    q = pv.VectorQuantizer(32, 3)
    q.embedding.data = torch.from_numpy(params["embedding"].copy()).requires_grad_()
    zt = nchw(z).requires_grad_()
    pzq, ploss, idx = q(zt)
    (ploss + (pzq * nchw(gout)).sum()).backward()
    close(nhwc(pzq), zq)
    close(ploss.item(), float(loss), atol=1e-7)
    close(nhwc(zt.grad), gz, atol=1e-6)
    close(q.embedding.grad.numpy(), gp["embedding"], atol=1e-6)
    assert idx.shape == (2, 4, 4)


@pytest.mark.parametrize("train", [True, False])
def test_gumbel_quantize_matches_with_the_jax_draws(train):
    """The JAX uniforms (the same key as its ``gumbel`` stream) fed in as
    ``u``: z_q, the KL loss, the indices and the gradients of loss + <z_q, g>
    with respect to z and every parameter; temperature 0.7."""
    rs = np.random.RandomState(6)
    z = rs.randn(2, 4, 4, 3).astype(np.float32)
    gout = rs.randn(2, 4, 4, 3).astype(np.float32)
    jq = jv.GumbelQuantize(32, 3, kl_weight=5e-3)
    params = jax.tree_util.tree_map(np.asarray, jq.init(jax.random.PRNGKey(1), z)["params"])
    key = jax.random.PRNGKey(7)

    def f(z, p):
        zq, loss, idx = jq.apply({"params": p}, z, temp=0.7, train=train, rngs={"gumbel": key})
        return loss + jnp.sum(zq * gout), (zq, loss, idx)

    (_, (zq, loss, idx)), (gz, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        z, params)
    u = gumbel_draw(jq, params, key, lambda m: m, (2, 4, 4, 32))
    q = pv.GumbelQuantize(32, 3, kl_weight=5e-3)
    load_module_trees(q, params)
    zt = nchw(z).requires_grad_()
    pzq, ploss, pidx = q(zt, temp=0.7, train=train, u=nchw(u))
    (ploss + (pzq * nchw(gout)).sum()).backward()
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(idx))
    close(nhwc(pzq), zq)
    close(ploss.item(), float(loss), atol=1e-8)
    close(nhwc(zt.grad), gz, atol=1e-5)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, gp), dict(q.named_parameters()))
    for name, p in q.named_parameters():
        close(p.grad.numpy(), want[name].numpy(), atol=1e-5)


@pytest.mark.parametrize("quantizer", ["nearest", "gumbel"])
def test_vqmodel_training_roundtrip_matches(quantizer):
    """``VQModel.forward`` in training mode (naive up-convs) against the JAX
    roundtrip as the JAX step calls it: (xrec, qloss) and the gradient of
    mean |x - xrec| + qloss with respect to every parameter; the Gumbel
    quantizer with the JAX draws. ``from_config`` honours ``quantizer`` and
    ``kl_weight``."""
    cfg = vq_params(quantizer)
    jm = jv.VQModel.from_config(cfg)
    rs = np.random.RandomState(8)
    x = rs.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2), x)["params"])
    key = jax.random.PRNGKey(9)
    gumbel = quantizer == "gumbel"
    kw = dict(temp=0.9, train=True, rngs={"gumbel": key}) if gumbel else {}

    def f(p):
        xr, ql = jm.apply({"params": p}, x, **kw)
        return jnp.abs(x - xr).mean() + ql, (xr, ql)

    (_, (xrec, qloss)), grads = jax.value_and_grad(f, has_aux=True)(params)
    port = pv.VQModel.from_config(cfg, device="cpu").train()
    assert port.quantizer_type == quantizer and port.quantize.__class__.__name__ == (
        "GumbelQuantize" if gumbel else "VectorQuantizer")
    port.load_state_dict(state_dict_from_jax(params, port))
    pkw = {}
    if gumbel:
        assert port.quantize.kl_weight == 5e-3
        u = gumbel_draw(jm, params, key, lambda m: m.quantize, (2, 8, 8, 32))
        pkw = dict(temp=0.9, train=True, u=nchw(u))
    xt = nchw(x)
    pxrec, pq = port(xt, **pkw)
    ((xt - pxrec).abs().mean() + pq).backward()
    close(nhwc(pxrec), xrec, atol=1e-4)
    close(pq.item(), float(qloss), atol=1e-7)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads), port)
    for name, p in port.named_parameters():
        close(p.grad.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-3)
