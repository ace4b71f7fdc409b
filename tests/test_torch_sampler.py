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


@pytest.fixture
def one_thread():
    """torch on one thread: the suite's workers hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sampler", ["euler", "heun"])
def test_coeff_table_holds_the_coeffs_entry_for_entry(sampler):
    from bbdm_tpu_torch.models import bridge

    port = port_build(configure(lbbdm_config(), sampler, 1.0), device="cpu")
    c, s = port.coeffs, port.schedule
    table = port.coeff_table(torch.zeros(1, 3, 8, 8))
    assert table.dtype == torch.float32 and table.shape == (len(c.steps), 12)
    nxt = np.append(c.steps[1:], c.steps[-1])
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    # 1 / (1 - m_t) in float64, then rounded: how the card divides by a Python float
    inv = lambda m_t: f32(1.0 / (1.0 - np.asarray(m_t, np.float64)))  # noqa: E731
    for col, want in ((bridge._A_XT, c.a_xt), (bridge._A_X0, c.a_x0), (bridge._A_Y, c.a_y),
                      (bridge._SIGMA, c.sigma), (bridge._NOW, c.steps),
                      (bridge._NOW + 1, c.m_t), (bridge._NOW + 2, c.sigma_fwd),
                      (bridge._NOW + 3, inv(c.m_t)), (bridge._NEXT, nxt),
                      (bridge._NEXT + 1, s.m_t[nxt]),
                      (bridge._NEXT + 2, np.sqrt(s.variance_t)[nxt]),
                      (bridge._NEXT + 3, inv(s.m_t[nxt]))):
        np.testing.assert_array_equal(table[:, col].numpy(), f32(want))
    # read at each call: a cut schedule (the benchmark's warm-up) gives a cut table
    port.coeffs = type(c)(**{k: v[:3] for k, v in vars(c).items()})
    assert port.coeff_table(torch.zeros(1)).shape == (3, 12)
    assert port.coeff_table(torch.zeros(1, dtype=torch.bfloat16)).dtype == torch.float32
    assert port.coeff_table(torch.zeros(1, dtype=torch.float64)).dtype == torch.float64


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("objective", ["grad", "noise", "ysubx"])
@pytest.mark.parametrize("sampler", ["euler", "heun"])
def test_step_body_gives_the_python_float_update_bit_for_bit(sampler, objective):
    """The step body with its coefficients as 0-d fp32 tensors against the
    update written with Python floats and int timesteps (the loop before the
    body took tensors), fp32, every step of the grid. The 'noise' objective's
    ``/ (1.0 - m_t)`` is written as the card computes it, a multiply by
    ``1.0 / (1.0 - m_t)``; the CPU divides, up to an ulp away."""
    from torch.func import functional_call

    cfg = configure(tiny_bbdm_config(), sampler, 1.0)
    cfg.BB.params.objective = objective
    port = port_build(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    y, x_t, eps = (torch.rand(2, 3, 8, 8, generator=g) * 2 - 1 for _ in range(3))
    c, params = port.coeffs, port._sampling_params()
    m, sig = port.schedule.m_t, np.sqrt(port.schedule.variance_t)
    table = port.coeff_table(y)

    def predict(x, t, m_t, sigma_t):
        tt = torch.full((2,), int(t), dtype=torch.int32)
        pred = functional_call(port.unet, params, (x, tt, y))
        if objective == "grad":
            x0 = x - pred
        elif objective == "noise":
            x0 = (x - float(m_t) * y - float(sigma_t) * pred) * (1.0 / (1.0 - float(m_t)))
        else:
            x0 = y - pred
        return x0.clamp(-1.0, 1.0)

    def update(i, x0, noise=None):
        x = float(c.a_xt[i]) * x_t + float(c.a_x0[i]) * x0 + float(c.a_y[i]) * y
        return x if noise is None else x + float(c.sigma[i]) * noise

    with torch.inference_mode(), port._sampling_mode():
        for i in range(len(c.steps) - (sampler == "heun")):
            x0 = predict(x_t, c.steps[i], c.m_t[i], c.sigma_fwd[i])
            if sampler == "heun":
                nt = int(c.steps[i + 1])
                x0 = 0.5 * (x0 + predict(update(i, x0), nt, m[nt], sig[nt]))
            got = port._reverse_step(params, x_t, y, y, table[i], eps, clip_denoised=True)
            assert torch.equal(got[0], update(i, x0, eps)) and torch.equal(got[1], x0), i


def test_scaled_keeps_fp32_arithmetic_for_16_bit_tensors():
    """A 16-bit tensor times a 0-d fp32 coefficient, as a Python float
    multiplies it: in fp32, rounded once (a plain product would round the
    coefficient to 16 bits first)."""
    from bbdm_tpu_torch.models.bridge import _scaled

    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    a = torch.tensor(0.3337, dtype=torch.float32)
    for dtype in (torch.bfloat16, torch.float16):
        xl = x.to(dtype)
        assert torch.equal(_scaled(a, xl), float(a) * xl)
        assert not torch.equal(a * xl, float(a) * xl)
    assert torch.equal(_scaled(a, x), float(a) * x)


@pytest.mark.usefixtures("one_thread")
def test_step_graph_is_off_on_the_cpu_and_under_a_model_axis(monkeypatch):
    import types

    from bbdm_tpu_torch.models import bridge
    from bbdm_tpu_torch.parallel import mesh
    from bbdm_tpu_torch.utils import spans

    assert not bridge._graph_steps(torch.zeros(1))
    card = types.SimpleNamespace(is_cuda=True)  # what the predicate reads of a card tensor
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert bridge._graph_steps(card)  # no process group: a 1 x 1 grid
    monkeypatch.setattr(mesh, "grid", lambda: types.SimpleNamespace(model_size=2))
    assert not bridge._graph_steps(card)
    monkeypatch.setattr(mesh, "grid", lambda: types.SimpleNamespace(model_size=1))
    assert bridge._graph_steps(card)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert not bridge._graph_steps(card)  # inside another capture
    monkeypatch.undo()
    port = port_build(configure(tiny_bbdm_config(), "euler", 1.0), device="cpu")
    spans.clear()
    port.p_sample_loop(torch.zeros(2, 3, 8, 8))
    names = {r.name for r in spans.records()}
    spans.clear()
    assert "sampler.step" in names and not names & {"sampler.capture", "sampler.replay"}
    assert not port._step_graphs and port._static_weights is None
