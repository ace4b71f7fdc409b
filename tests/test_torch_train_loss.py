"""The port's training loss and its gradients against the JAX package, on the CPU.

Tiny models (tests/conftest.py ``tiny_bbdm_config``: pixel BBDM at 8^2, UNet
mc 32; tests/test_latent.py ``lbbdm_config``: LBBDM at 16^2 with a 4^2
latent), fp32, the JAX package's initial weights carried over by
``checkpoints/from_jax.py``, inputs from a numpy seed. The JAX loss draws t and
the noise from its key (``bbdm_tpu/models/bridge.py:196-199``); the test
repeats those draws and feeds them to the port (``t=``, ``noise=``): the two
frameworks' random streams differ. The port's model is in training mode, as
the JAX loss runs the UNet with ``train=True``.

Bars: the loss within 2e-4; each gradient leaf within 2e-4 absolute plus
1e-4 relative (the same products summed in another order; parameter
gradients are sums over batch and pixels).
"""

import jax
import numpy as np
import pytest
import torch
from test_latent import lbbdm_config

from bbdm_tpu.models import build_model as jax_build
from bbdm_tpu_torch.checkpoints.from_jax import jax_tree_from_state_dict, state_dict_from_jax
from bbdm_tpu_torch.models import build_model as port_build
from tests.conftest import tiny_bbdm_config

ATOL, RTOL = 2e-4, 1e-4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


CONFIGS = {"bbdm": (tiny_bbdm_config, 8), "lbbdm-nocond": (lambda: lbbdm_config("nocond"), 16),
           "lbbdm-sr": (lambda: lbbdm_config("SpatialRescaler"), 16)}


@pytest.fixture(scope="module")
def params():
    """JAX initial parameters of each model, as numpy trees."""
    out = {}
    for name, (make, _) in CONFIGS.items():
        m = jax_build(make())
        out[name] = jax.tree_util.tree_map(np.asarray,
                                           jax.jit(m.init_params)(jax.random.PRNGKey(0)))
    return out


def batch(size, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    return x, np.clip(-x + rs.uniform(-0.2, 0.2, x.shape), -1, 1).astype(np.float32)


def jax_draws(jm, key, shape):
    """The t and noise ``BrownianBridgeModel.loss`` draws from ``key`` for x of ``shape``."""
    t_rng, n_rng = jax.random.split(key)
    t = jax.random.randint(t_rng, (shape[0],), 0, jm.num_timesteps)
    return torch.from_numpy(np.array(t)), nchw(jax.random.normal(n_rng, shape))


def port_model(cfg, tree):
    m = port_build(cfg, device="cpu")
    m.load_state_dict(state_dict_from_jax(tree, m))
    return m.train()


def latent_shape(jm, params, x):
    if not hasattr(jm, "encode"):
        return x.shape
    return jax.eval_shape(lambda p, x: jm.encode(p, x), params, x).shape


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
@pytest.mark.parametrize("objective", ["grad", "noise", "ysubx"])
def test_pixel_loss_matches_jax(params, objective, loss_type):
    cfg = tiny_bbdm_config()
    cfg.BB.params.objective, cfg.BB.params.loss_type = objective, loss_type
    jm = jax_build(cfg)
    x, y = batch(8)
    key = jax.random.PRNGKey(5)
    loss, aux = jax.jit(lambda p: jm.loss(p, key, x, y))(params["bbdm"])
    t, noise = jax_draws(jm, key, x.shape)
    port = port_model(cfg, params["bbdm"])
    ploss, paux = port.loss(nchw(x), nchw(y), t=t, noise=noise)
    assert abs(ploss.item() - float(loss)) <= ATOL
    np.testing.assert_allclose(nhwc(paux["x0_recon"]), np.asarray(aux["x0_recon"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_gradients_match_jax_grad(params, name):
    """Loss and every trainable gradient leaf against ``jax.grad``; the frozen
    VQGAN gets no gradient in the port (the JAX package's are zeros through
    ``stop_gradient``), the SpatialRescaler's channel mapper one."""
    make, size = CONFIGS[name]
    cfg = make()
    jm = jax_build(cfg)
    x, y = batch(size, seed=1)
    key = jax.random.PRNGKey(6)
    (loss, _), grads = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, key, x, y),
                                                  has_aux=True))(params[name])
    t, noise = jax_draws(jm, key, latent_shape(jm, params[name], x))
    port = port_model(cfg, params[name])
    ploss, _ = port.loss(nchw(x), nchw(y), t=t, noise=noise)
    ploss.backward()
    assert abs(ploss.item() - float(loss)) <= ATOL

    trainable = port.trainable_parameters()
    assert all(p.grad is not None for p in trainable.values())
    assert all(p.grad is None for n, p in port.named_parameters() if n not in trainable)
    if name.startswith("lbbdm"):
        assert not any(n.startswith("vqgan.") for n in trainable)
    if name == "lbbdm-sr":
        assert "cond_stage.channel_mapper.weight" in trainable
    got = jax_tree_from_state_dict({n: p.grad for n, p in trainable.items()})
    want = jax.tree_util.tree_map(np.asarray, grads)
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat) == len(trainable)
    for path, g in flat:
        ref = want
        for k in path:
            ref = ref[k.key]
        np.testing.assert_allclose(g, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))
