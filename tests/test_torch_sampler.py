"""The port's heun sampler, mid-step trajectories, SpatialRescaler and pixel
BBDM against the JAX package, same weights through ``checkpoints/from_jax.py``,
on the CPU.

fp32 within 2e-4 (the slice's bar, ``tests/test_torch_slice.py``); with eta 1
the port is fed the JAX draws, rebuilt from the key split chain of
``bbdm_tpu/models/bridge.py:355-362``; the bf16 bar is the slice's (twice JAX's
own bf16-vs-fp32 distance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_latent import lbbdm_config

from bbdm_tpu.models import build_model as jax_build
from bbdm_tpu.models.cond import SpatialRescaler as JaxRescaler
from bbdm_tpu_torch.checkpoints.from_jax import state_dict_from_jax
from bbdm_tpu_torch.config import dict2namespace
from bbdm_tpu_torch.models import build_model as port_build
from bbdm_tpu_torch.models.cond import SpatialRescaler
from tests.conftest import tiny_bbdm_config

ATOL = 2e-4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().movedim(-3, -1).float().numpy()


def configure(cfg, sampler, eta, mixed=False):
    cfg.BB.params.sampler = sampler
    cfg.BB.params.eta = eta
    cfg.mixed_precision = mixed
    return cfg


def init(cfg, seed=0):
    m = jax_build(cfg)
    return m, jax.tree_util.tree_map(np.asarray, jax.jit(m.init_params)(jax.random.PRNGKey(seed)))


def port_model(cfg, params):
    m = port_build(cfg, device="cpu")
    m.load_state_dict(state_dict_from_jax(params, m))
    return m


def jax_draws(key, shape, n):
    """The draws of n steps of the sampler's scan body for ``key``, NCHW."""
    out = []
    for _ in range(n):
        key, step_key = jax.random.split(key)
        out.append(nchw(jax.random.normal(step_key, shape, jnp.float32)))
    return out


@pytest.fixture(scope="module")
def lbbdm():
    cfg = lbbdm_config()
    _, params = init(cfg)
    return params


@pytest.fixture(scope="module")
def x_cond():
    return np.random.RandomState(7).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_heun_latent_matches_jax(lbbdm, x_cond, eta):
    cfg = configure(lbbdm_config(), "heun", eta)
    jm = jax_build(cfg)
    y = jax.jit(lambda p, x: jm.encode(p, x, cond=True))(lbbdm, x_cond)
    key = jax.random.PRNGKey(4)
    z = jax.jit(lambda p, r, y: jm.p_sample_loop(p, r, y, clip_denoised=False))(lbbdm, key, y)
    port = port_model(cfg, lbbdm)
    assert port.noised_steps() == len(port.coeffs.steps) - 1
    noise = jax_draws(key, y.shape, port.noised_steps()) if eta else None
    pz = port.p_sample_loop(nchw(y), clip_denoised=False, noise=noise)
    np.testing.assert_allclose(nhwc(pz), np.asarray(z), rtol=1e-4, atol=ATOL)
    if not eta:  # eta 0: no draw reaches the result
        pz2 = port.p_sample_loop(nchw(y), clip_denoised=False,
                                 generator=torch.Generator().manual_seed(9))
        np.testing.assert_array_equal(pz2.numpy(), pz.numpy())


@pytest.mark.parametrize("sampler", ["euler", "heun"])
def test_mid_step_trajectories_match_jax(lbbdm, x_cond, sampler):
    """Both trajectories of p_sample_loop, and LBBDM.sample with both decoded."""
    cfg = configure(lbbdm_config(), sampler, 0.0)
    jm = jax_build(cfg)
    y = jax.jit(lambda p, x: jm.encode(p, x, cond=True))(lbbdm, x_cond)
    key = jax.random.PRNGKey(1)
    imgs, one = jax.jit(lambda p, r, y: jm.p_sample_loop(p, r, y, clip_denoised=False,
                                                         sample_mid_step=True))(lbbdm, key, y)
    port = port_model(cfg, lbbdm)
    pi, po = port.p_sample_loop(nchw(y), clip_denoised=False, sample_mid_step=True)
    S = len(port.coeffs.steps)
    assert pi.shape == po.shape == (S, 2, 3, 8, 8)
    np.testing.assert_allclose(nhwc(pi), np.asarray(imgs), rtol=1e-4, atol=ATOL)
    np.testing.assert_allclose(nhwc(po), np.asarray(one), rtol=1e-4, atol=ATOL)

    dec_i, dec_o = jax.jit(lambda p, r, x: jm.sample(p, r, x, clip_denoised=False,
                                                     sample_mid_step=True))(lbbdm, key, x_cond)
    qi, qo = port.sample(nchw(x_cond), sample_mid_step=True)
    assert qi.shape == qo.shape == (S, 2, 3, 16, 16)
    np.testing.assert_allclose(nhwc(qi), np.asarray(dec_i), rtol=1e-4, atol=ATOL)
    np.testing.assert_allclose(nhwc(qo), np.asarray(dec_o), rtol=1e-4, atol=ATOL)


@pytest.mark.parametrize("n_stages,out_channels,size", [(1, 3, 16), (2, 3, 16), (2, None, 12),
                                                        (1, 4, 10)])
def test_spatial_rescaler_matches_jax(n_stages, out_channels, size):
    cond = dict2namespace({"n_stages": n_stages, "in_channels": 3,
                           "out_channels": out_channels})
    jr = JaxRescaler.from_config(cond, dtype=jnp.float32)
    x = np.random.RandomState(n_stages).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    variables = jr.init(jax.random.PRNGKey(0), x)
    params = jax.tree_util.tree_map(np.asarray, variables.get("params", {}))
    out = jr.apply(variables, x)
    port = SpatialRescaler.from_config(cond, dtype=torch.float32)
    if out_channels is None:
        assert not params and not list(port.parameters())
    else:
        port.load_state_dict(state_dict_from_jax(params, port))
        assert port.channel_mapper.bias is None
    np.testing.assert_allclose(nhwc(port(nchw(x))), np.asarray(out), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sampler", ["euler", "heun"])
def test_lbbdm_with_spatial_rescaler_matches_jax(x_cond, sampler):
    cfg = configure(lbbdm_config("SpatialRescaler"), sampler, 0.0)
    jm, params = init(cfg, seed=3)
    ctx = jax.jit(jm.get_cond_stage_context)(params, x_cond)
    img = jax.jit(lambda p, r, x: jm.sample(p, r, x, clip_denoised=False))(
        params, jax.random.PRNGKey(0), x_cond)
    port = port_model(cfg, params)
    np.testing.assert_allclose(nhwc(port.get_cond_stage_context(nchw(x_cond))),
                               np.asarray(ctx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nhwc(port.sample(nchw(x_cond))), np.asarray(img),
                               rtol=1e-4, atol=ATOL)


@pytest.mark.parametrize("sampler,eta", [("euler", 0.0), ("heun", 0.0), ("euler", 1.0),
                                         ("heun", 1.0)])
def test_pixel_bbdm_matches_jax(sampler, eta):
    """tests/conftest.py:tiny_bbdm_config (condition concatenated to x_t),
    two draws, clip_denoised as the JAX model's default."""
    cfg = configure(tiny_bbdm_config(), sampler, eta)
    jm, params = init(cfg, seed=2)
    y = np.random.RandomState(5).uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    out = jax.jit(lambda p, r, y: jm.sample(p, r, y, num_samples=2))(params, key, y)
    port = port_model(cfg, params)
    noise = None
    if eta:
        noise = [jax_draws(k, y.shape, port.noised_steps()) for k in jax.random.split(key, 2)]
    pout = port.sample(nchw(y), num_samples=2, noise=noise)
    assert pout.shape == (2, 2, 3, 8, 8)
    np.testing.assert_allclose(nhwc(pout), np.asarray(out), rtol=1e-4, atol=ATOL)


def test_heun_bf16_latent_matches_jax(lbbdm, x_cond):
    cb, cf = (configure(lbbdm_config(), "heun", 0.0, mixed=m) for m in (True, False))
    jb, jf = jax_build(cb), jax_build(cf)
    y = np.asarray(jax.jit(lambda p, x: jb.encode(p, x, cond=True))(lbbdm, x_cond))
    key = jax.random.PRNGKey(1)
    z_b = np.asarray(jax.jit(lambda p, r, y: jb.p_sample_loop(p, r, y, clip_denoised=False))(
        lbbdm, key, y))
    z_f = np.asarray(jax.jit(lambda p, r, y: jf.p_sample_loop(p, r, y, clip_denoised=False))(
        lbbdm, key, y))
    pz = port_model(cb, lbbdm).p_sample_loop(nchw(y), clip_denoised=False)
    assert pz.dtype == torch.float32
    # each bf16 run strays from the fp32 result by about JAX's own distance
    assert np.abs(nhwc(pz) - z_b).max() <= 2 * np.abs(z_b - z_f).max()


def test_noise_count_is_checked(lbbdm):
    port = port_model(configure(lbbdm_config(), "heun", 1.0), lbbdm)
    y = torch.zeros(1, 3, 8, 8)
    with pytest.raises(ValueError, match=f"need {port.noised_steps()} noise tensors"):
        port.p_sample_loop(y, noise=[y] * len(port.coeffs.steps))


def test_unknown_sampler_raises():
    with pytest.raises(NotImplementedError, match="sampler 'ddim'"):
        port_build(configure(lbbdm_config(), "ddim", 0.0), device="cpu")


def test_pixel_sample_hands_the_kernels_contiguous_tensors(monkeypatch):
    """The runner passes an NCHW view of an NHWC batch; K1 takes only
    NCHW-contiguous tensors on the card, so every GroupNorm input must be
    contiguous (the CPU twin would accept any layout)."""
    from bbdm_tpu_torch.ops import group_norm

    seen = []
    plain = group_norm.group_norm

    def checking(x, *a, **k):
        seen.append(x.is_contiguous())
        return plain(x, *a, **k)

    monkeypatch.setattr(group_norm, "group_norm", checking)
    port = port_build(configure(tiny_bbdm_config(), "heun", 0.0), device="cpu")
    y = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (2, 8, 8, 3)).astype(
        np.float32)).permute(0, 3, 1, 2)
    assert not y.is_contiguous()
    port.sample(y)
    assert seen and all(seen)
