"""The port's LBBDM sampling slice against the JAX package, end to end, on the CPU.

A tiny LBBDM (the ``lbbdm_config`` scale of tests/test_latent.py: 16^2 images,
VQGAN ch 32, UNet mc 32, 4 sampling steps) with the JAX package's initial
weights carried over by ``checkpoints/from_jax.py``; inputs from a numpy seed,
NHWC for JAX and NCHW for the port.

* fp32, eta=0: condition latent, sampled latent and decoded image within 2e-4,
  VQ indices equal. The argmin can flip where two codebook distances (nearly)
  tie: the test first requires equal indices wherever the best-vs-second gap
  is larger than a 2e-4 latent error can move, then everywhere (no tie flips
  at this seed), so a failure of the first is a real fault, of the second a tie.
* fp32, eta=1, two draws: the port is fed the JAX draws, rebuilt with the key
  split chain of bbdm_tpu/models/bridge.py:289-298.
* bf16 (mixed_precision): sampled latent against the JAX bf16 run, with the
  tolerance stated there.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_latent import lbbdm_config

from bbdm_tpu.config import dict2namespace
from bbdm_tpu.models import build_model as jax_build
from bbdm_tpu.models.vqgan import VQModel
from bbdm_tpu_torch.checkpoints.from_jax import state_dict_from_jax
from bbdm_tpu_torch.models import build_model as port_build
from bbdm_tpu_torch.runners.bbdm import BBDMRunner

ATOL = 2e-4


def config(eta=0.0, mixed=False):
    cfg = lbbdm_config(mixed_precision=mixed)
    cfg.BB.params.eta = eta
    return cfg


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


class JaxSide:
    """Jitted pieces of the JAX LatentBrownianBridgeModel.sample."""

    def __init__(self, cfg, params):
        self.m, self.params = jax_build(cfg), params
        m = self.m
        self._encode = jax.jit(lambda p, x: m.encode(p, x, cond=True))
        self._loop = jax.jit(lambda p, r, y: m.p_sample_loop(p, r, y, clip_denoised=False))

        def quant_decode(p, z):
            vq = {"params": p["vqgan"]}
            q, _, idx = m.vqgan.apply(vq, z, method=VQModel.quantize_latent)
            return idx, m.vqgan.apply(vq, q, method=VQModel.decode_from_quant)

        self._quant_decode = jax.jit(quant_decode)

    def encode(self, x):
        return self._encode(self.params, x)

    def loop(self, key, y):
        return self._loop(self.params, key, y)

    def quant_decode(self, z):
        return self._quant_decode(self.params, z)

    def noise(self, key, shape, steps):
        """The per-step draws of p_sample_loop's scan body for ``key``, NCHW."""
        out = []
        for _ in range(steps):
            key, step_key = jax.random.split(key)
            out.append(nchw(jax.random.normal(step_key, shape, jnp.float32)))
        return out


@pytest.fixture(scope="module")
def params():
    m = jax_build(config())
    p = jax.jit(m.init_params)(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


def port_model(cfg, params):
    m = port_build(cfg, device="cpu")
    m.load_state_dict(state_dict_from_jax(params, m))
    return m


@pytest.fixture(scope="module")
def x_cond():
    return np.random.RandomState(7).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)


def test_fp32_eta0_sample_matches_jax(params, x_cond):
    js = JaxSide(config(eta=0.0), params)
    y = js.encode(x_cond)
    z = js.loop(jax.random.PRNGKey(1), y)
    idx, img = js.quant_decode(z)

    port = port_model(config(eta=0.0), params)
    py = port.encode(nchw(x_cond))
    np.testing.assert_allclose(nhwc(py), np.asarray(y), rtol=1e-4, atol=ATOL)
    pz = port.p_sample_loop(py, clip_denoised=False)
    np.testing.assert_allclose(nhwc(pz), np.asarray(z), rtol=1e-4, atol=ATOL)

    # A latent error of at most ATOL per component moves the gap between two
    # codebook distances by at most 2 * |e_i - e_j|_1 * ATOL: positions whose
    # best-vs-second gap is under that are ties and may flip; all others must
    # match. (At this seed no tie flips either, so all indices match.)
    e = params["vqgan"]["quantize"]["embedding"].astype(np.float64)
    flat = np.asarray(z, np.float64).reshape(-1, e.shape[1])
    d = np.sort(((flat[:, None, :] - e[None]) ** 2).sum(-1), axis=1)
    bound = 2 * np.abs(e[:, None] - e[None]).sum(-1).max() * ATOL
    tie = (d[:, 1] - d[:, 0] < bound).reshape(np.asarray(idx).shape)
    _, _, pidx = port.vqgan.quantize_latent(pz)
    np.testing.assert_array_equal(pidx.numpy()[~tie], np.asarray(idx)[~tie])
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(idx))

    out = port.sample(nchw(x_cond))  # the public entry: encode, loop, decode
    np.testing.assert_allclose(nhwc(out), np.asarray(img), rtol=1e-4, atol=ATOL)


def test_fp32_eta1_two_draws_with_jax_noise_match(params, x_cond):
    js = JaxSide(config(eta=1.0), params)
    y = js.encode(x_cond)
    keys = jax.random.split(jax.random.PRNGKey(2), 2)  # LatentBrownianBridgeModel.sample
    port = port_model(config(eta=1.0), params)
    steps = len(port.coeffs.steps)
    noise = [js.noise(k, y.shape, steps) for k in keys]

    imgs = []
    for k, step_noise in zip(keys, noise):
        z = js.loop(k, y)
        pz = port.p_sample_loop(nchw(y), clip_denoised=False, noise=step_noise)
        np.testing.assert_allclose(nhwc(pz), np.asarray(z), rtol=1e-4, atol=ATOL)
        imgs.append(np.asarray(js.quant_decode(z)[1]))

    out = port.sample(nchw(x_cond), num_samples=2, noise=noise)
    assert out.shape == (2, 2, 3, 16, 16)
    np.testing.assert_allclose(out.permute(0, 1, 3, 4, 2).numpy(), np.stack(imgs),
                               rtol=1e-4, atol=ATOL)


def test_bf16_latent_matches_jax(params, x_cond):
    jb, jf = JaxSide(config(mixed=True), params), JaxSide(config(), params)
    key = jax.random.PRNGKey(1)
    y_b, y_f = np.asarray(jb.encode(x_cond)), np.asarray(jf.encode(x_cond))
    z_b, z_f = np.asarray(jb.loop(key, y_b)), np.asarray(jf.loop(key, y_b))
    port = port_model(config(mixed=True), params)
    py = port.encode(nchw(x_cond))
    pz = port.p_sample_loop(nchw(y_b), clip_denoised=False)
    assert pz.dtype == torch.float32
    # Tolerance: bf16 keeps 8 significant bits, and XLA and torch round conv
    # outputs, bias adds and residual sums at different places. Each bf16 run
    # strays from the fp32 result by about the same amount, in directions of
    # its own, so the two bf16 runs may be up to twice JAX's own bf16-vs-fp32
    # distance apart (with random weights the 4 UNet steps amplify it to ~0.1
    # on latents of order 1).
    assert np.abs(nhwc(py) - y_b).max() <= 2 * np.abs(y_b - y_f).max()
    assert np.abs(nhwc(pz) - z_b).max() <= 2 * np.abs(z_b - z_f).max()


@pytest.mark.parametrize("over", [{"normalize_latent": True},
                                  {"latent_before_quant_conv": True}])
def test_encode_decode_options_match_jax(params, x_cond, over):
    """Latent-stat normalisation and latent_before_quant_conv, off in the f4
    template, through both encode and decode."""
    from bbdm_tpu.models.latent import LatentBrownianBridgeModel as JaxLBBDM

    cfg = config()
    for k, v in over.items():
        cfg[k] = v
    jm = jax_build(cfg)
    rs = np.random.RandomState(9)
    stats = {k: rs.uniform(0.5, 1.5, (1, 1, 1, 3)).astype(np.float32)
             for k in ("ori_latent_mean", "ori_latent_std", "cond_latent_mean",
                       "cond_latent_std")}
    enc = jax.jit(lambda p, x: JaxLBBDM.encode(jm, p, x, cond=True, latent_stats=stats))
    dec = jax.jit(lambda p, z: JaxLBBDM.decode(jm, p, z, cond=False, latent_stats=stats))
    y = enc(params, x_cond)
    img = dec(params, y)

    port = port_model(cfg, params)
    pstats = {k: nchw(v) for k, v in stats.items()}
    py = port.encode(nchw(x_cond), cond=True, latent_stats=pstats)
    np.testing.assert_allclose(nhwc(py), np.asarray(y), rtol=1e-4, atol=ATOL)
    out = port.decode(nchw(y), cond=False, latent_stats=pstats)
    np.testing.assert_allclose(nhwc(out), np.asarray(img), rtol=1e-4, atol=ATOL)


@pytest.mark.parametrize("sample_num", [1, 2])
def test_sample_to_eval_tree(tmp_path, sample_num):
    from PIL import Image

    cfg = dict2namespace({
        "model": config().to_dict(),
        "testing": {"sample_num": sample_num, "clip_denoised": False},
        "data": {"dataset_config": {"to_normal": True}},
    })
    runner = BBDMRunner(cfg, device="cpu", seed=3)
    rs = np.random.RandomState(8)
    batches = [{"x": rs.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32),
                "x_cond": rs.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32),
                "x_name": [f"a{b}{i}" for i in range(2)],
                "x_cond_name": [f"c{b}{i}" for i in range(2)]} for b in range(2)]
    runner.sample_to_eval(batches, str(tmp_path))

    step = str(cfg.model.BB.params.sample_step)
    assert sorted(os.listdir(tmp_path)) == sorted(["condition", "ground_truth", step])
    names = ["a00", "a01", "a10", "a11"]
    assert sorted(os.listdir(tmp_path / "ground_truth")) == [f"{n}.png" for n in names]
    assert sorted(os.listdir(tmp_path / "condition")) == ["c00.png", "c01.png", "c10.png",
                                                          "c11.png"]
    if sample_num == 1:
        assert sorted(os.listdir(tmp_path / step)) == [f"{n}.png" for n in names]
        outs = [tmp_path / step / f"{n}.png" for n in names]
    else:
        assert sorted(os.listdir(tmp_path / step)) == names
        for n in names:
            assert sorted(os.listdir(tmp_path / step / n)) == ["output_0.png", "output_1.png"]
        outs = [tmp_path / step / n / f"output_{j}.png" for n in names for j in range(2)]
    for p in outs:
        assert np.asarray(Image.open(p)).shape == (16, 16, 3)
    from bbdm_tpu.utils.images import to_uint8

    gt = np.asarray(Image.open(tmp_path / "ground_truth" / "a10.png"))
    np.testing.assert_array_equal(gt, to_uint8(batches[1]["x"][0]))


@pytest.mark.parametrize("card", ["as found", "absent"])
@pytest.mark.parametrize("entry", ["build_model", "BBDMRunner"])
def test_entry_points_default_to_the_card(monkeypatch, entry, card):
    """Without a device, build_model and BBDMRunner take the CUDA card, and raise
    where there is none: they never fall back to the CPU. Whether a card is
    present is read here, when the test runs ("absent" hides any card)."""
    if card == "absent":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict2namespace({"model": config().to_dict(), "testing": {"sample_num": 1},
                          "data": {"dataset_config": {"to_normal": True}}})
    build = (lambda: port_build(cfg.model)) if entry == "build_model" else \
        (lambda: BBDMRunner(cfg).model)
    if torch.cuda.is_available():
        assert next(build().parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            build()
