"""The port's new model methods and user tools against the JAX package, on the CPU.

* ``BrownianBridgeModel.q_sample_loop`` with the JAX draws injected and
  ``LatentBrownianBridgeModel.sample_vqgan`` on a tiny VQGAN: fp32 within
  2e-4 absolute plus 1e-4 relative.
* ``tools/convert_checkpoint.py`` against ``scripts/convert_checkpoint.py``
  for its three kinds: both outputs read with the JAX package's
  ``load_checkpoint`` are equal leaf by leaf, bit for bit, and the printed
  lines are the same.
* ``tools/vqgan_recon.py --cpu --fp32`` against
  ``scripts/eval_vqgan_recon.py --cpu --fp32`` (run in this process, its
  compilation-cache settings left out and its flax init, which the
  checkpoint overwrites, taken from shapes) on the same weights and 4 PNGs: every
  PNG within 1 uint8 level, PSNR within 0.05 dB and SSIM within 1e-3 (a pixel
  that rounds the other way moves the PSNR of a 16^2 image by < 0.02 dB).
* ``tools/sampler_sweep.py``: the reports' ``nfe``, the resume, and samples
  equal to a ``main_torch.py --sample_to_eval`` run with the same overrides.
"""

import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_latent import lbbdm_config
from test_torch_checkpoints import assert_trees_equal, write_reference_pth
from test_torch_import import _vqgan_torch_keys
from test_torch_parallel import one_thread
from torch_mirrors import LPIPSMirror

import main_torch
from bbdm_tpu.checkpoints.io import load_checkpoint as jax_load_checkpoint
from bbdm_tpu.models import build_model as jax_build
from bbdm_tpu.models.vqgan import VQModel as JaxVQModel
from bbdm_tpu_torch.checkpoints.from_jax import jax_tree_from_state_dict
from bbdm_tpu_torch.checkpoints.io import save_checkpoint
from bbdm_tpu_torch.config import dict2namespace, load_config, save_config
from bbdm_tpu_torch.models import build_model as port_build
from bbdm_tpu_torch.tools import convert_checkpoint, sampler_sweep, vqgan_recon
from bbdm_tpu_torch.utils.images import read_png, write_png
from tests.conftest import tiny_bbdm_config

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """torch on one thread for each test: the suite's workers already hold every
    core, and idle OpenMP threads spin (``test_torch_parallel.one_thread``)."""
    with one_thread():
        yield


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 2e-4, 1e-4


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------ model methods

def test_q_sample_loop_matches_jax_with_its_draws():
    """The JAX loop's per-step keys (split, draw) replayed outside its scan and
    fed to the port as ``noise=``."""
    cfg = tiny_bbdm_config()
    jm = jax_build(cfg)
    port = port_build(cfg, device="cpu")
    rs = np.random.RandomState(0)
    x0, y = (rs.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(jm.q_sample_loop)(rng, jnp.asarray(x0), jnp.asarray(y)))
    draws, key = [], rng
    for _ in range(port.num_timesteps):
        key, step = jax.random.split(key)
        draws.append(torch.from_numpy(np.asarray(
            jax.random.normal(step, x0.shape, jnp.float32)).transpose(0, 3, 1, 2).copy()))
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
    got = port.q_sample_loop(nchw(x0), nchw(y), noise=draws)
    assert got.shape == (port.num_timesteps, 2, 3, 8, 8) == tuple(
        np.moveaxis(want, -1, 2).shape)
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="noise tensors"):
        port.q_sample_loop(nchw(x0), nchw(y), noise=draws[1:])


def test_q_sample_loop_draws_fresh_noise_in_x0s_dtype():
    port = port_build(tiny_bbdm_config(), device="cpu")
    x0 = torch.zeros(2, 3, 4, 4, dtype=torch.bfloat16)
    out = port.q_sample_loop(x0, x0, generator=torch.Generator().manual_seed(0))
    assert out.shape == (port.num_timesteps, 2, 3, 4, 4)
    assert out.dtype == torch.float32  # the fp32 schedule promotes, as in JAX
    assert torch.isfinite(out).all() and not torch.equal(out[1], out[2])
    # x0 = y = 0: each step is sigma_t * its noise, the noise drawn in bf16
    noise = out[5] / torch.sqrt(port._variance_t[5])
    torch.testing.assert_close(noise, noise.bfloat16().float(), rtol=1e-6, atol=0)


def test_sample_vqgan_matches_jax():
    cfg = lbbdm_config()
    port = port_build(cfg, device="cpu")
    tree = jax_tree_from_state_dict(port)
    jm = jax_build(cfg)
    x = np.random.RandomState(1).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.sample_vqgan)({"vqgan": tree["vqgan"]}, jnp.asarray(x)))
    got = port.sample_vqgan(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert not got.requires_grad and port.vqgan.training is False
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------- convert_checkpoint

def taming_checkpoint(path):
    """A taming-layout VQGAN training checkpoint: the autoencoder, a 2-layer
    BatchNorm PatchGAN under ``loss.discriminator.main.*`` and LPIPS-VGG
    (``tests/torch_mirrors.py``, taming's names) under ``loss.perceptual_loss.*``."""
    rs = np.random.RandomState(4)
    sd = _vqgan_torch_keys(32, (1, 2), 1, 3, 3, 32, 16)
    del sd["loss.dummy"]
    chans = [3, 8, 16, 32]
    main = {"main.0.weight": rs.randn(8, 3, 4, 4), "main.0.bias": rs.randn(8)}
    for n in range(1, 3):
        main[f"main.{2 + (n - 1) * 3}.weight"] = rs.randn(chans[n + 1], chans[n], 4, 4)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            main[f"main.{3 + (n - 1) * 3}.{leaf}"] = rs.randn(chans[n + 1])
    main["main.8.weight"], main["main.8.bias"] = rs.randn(1, 32, 4, 4), rs.randn(1)
    sd.update({f"loss.discriminator.{k}": v for k, v in main.items()})
    sd = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}
    torch.manual_seed(6)
    lp = LPIPSMirror("vgg").state_dict()
    sd.update({f"loss.perceptual_loss.{'scaling_layer.' + k if k in ('shift', 'scale') else k}": v
               for k, v in lp.items()})
    torch.save({"state_dict": sd}, path)


def run_script(monkeypatch, script, argv):
    """A script of ``scripts/`` as ``__main__`` in this process."""
    monkeypatch.setattr(sys, "argv", [script] + argv)
    runpy.run_path(os.path.join(REPO, "scripts", script), run_name="__main__")


@pytest.fixture(scope="module")
def reference_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("convert")
    cfg = lbbdm_config("SpatialRescaler")
    tree = jax_tree_from_state_dict(port_build(cfg, device="cpu"))
    write_reference_pth(str(root / "ref.pth"), cfg, tree, tree, seed=5)
    save_config(dict2namespace({"model": cfg.to_dict()}), str(root / "cfg.yaml"))
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in _vqgan_torch_keys(
        32, (1, 2), 1, 3, 3, 32, 16).items() if not k.startswith("loss.")}},
        str(root / "ldm.ckpt"))
    taming_checkpoint(str(root / "taming.ckpt"))
    return root


@pytest.mark.parametrize("kind,src,extra", [
    ("bbdm", "ref.pth", ["-c", "cfg.yaml"]),
    ("vqgan", "ldm.ckpt", []),
    ("vqgan-train", "taming.ckpt", ["--lpips-out", "{out}/lpips.ckpt"]),
    ("vqgan-train", "taming.ckpt", []),
])
def test_convert_checkpoint_writes_the_jax_tree(reference_files, tmp_path, monkeypatch, capsys,
                                                kind, src, extra):
    root = reference_files
    outs = {}
    for side in ("jax", "port"):
        out = tmp_path / side
        argv = [kind, "-i", str(root / src), "-o", str(out / "out.ckpt")] + [
            a.format(out=out) if "{" in a else (str(root / a) if a.endswith(".yaml") else a)
            for a in extra]
        if side == "jax":
            run_script(monkeypatch, "convert_checkpoint.py", argv)
        else:
            convert_checkpoint.main(argv)
        outs[side] = capsys.readouterr().out.replace(str(out), "<out>")
    assert outs["jax"] == outs["port"]
    names = ["out.ckpt"] + (["lpips.ckpt"] if extra and kind == "vqgan-train" else [])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(names)
    for name in names:
        want = jax_load_checkpoint(str(tmp_path / "jax" / name))
        got = jax_load_checkpoint(str(tmp_path / "port" / name))
        assert_trees_equal(got, want)
    if kind == "vqgan-train":
        assert "disc_num_layers=2 use_actnorm=False disc_ndf=8" in outs["port"]


def test_convert_checkpoint_bbdm_needs_a_config(reference_files):
    with pytest.raises(SystemExit):
        convert_checkpoint.main(["bbdm", "-i", str(reference_files / "ref.pth"), "-o", "x"])


# -------------------------------------------------------------- vqgan_recon

def test_vqgan_recon_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    cfg = lbbdm_config()
    tree = jax_tree_from_state_dict(port_build(cfg, device="cpu"))
    save_checkpoint({"vqgan": tree["vqgan"]}, str(tmp_path / "vq.ckpt"))
    save_config(dict2namespace({"model": cfg.to_dict()}), str(tmp_path / "cfg.yaml"))
    rs = np.random.RandomState(2)
    yy, xx = np.mgrid[0:16, 0:16] / 16
    os.makedirs(tmp_path / "data")
    for i in range(4):
        img = np.sin(5 * yy[..., None] + 3 * xx[..., None] + rs.uniform(0, 6, 3))
        write_png(str(tmp_path / "data" / f"{i:02d}.png"),
                  np.clip(img * 100 + 128 + rs.uniform(-20, 20, (16, 16, 3)), 0, 255)
                  .astype(np.uint8))
    argv = ["--config", str(tmp_path / "cfg.yaml"), "--vq-ckpt", str(tmp_path / "vq.ckpt"),
            "--data", str(tmp_path / "data"), "--batch", "2", "--fp32", "--cpu"]
    real_update = jax.config.update
    skipped = ("jax_platforms", "jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: None if k in skipped else real_update(k, v))
    real_init = JaxVQModel.init

    def shaped_init(self, rng, *a, **kw):
        """The flax init's tree of zeros (the checkpoint overwrites every leaf),
        from its shapes: the eager init of a VQGAN takes ~15 s of CPU."""
        shapes = jax.eval_shape(lambda r, *x: real_init(self, r, *x, **kw), rng, *a)
        return jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype), shapes)

    monkeypatch.setattr(JaxVQModel, "init", shaped_init)
    run_script(monkeypatch, "eval_vqgan_recon.py", argv + ["--out", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = vqgan_recon.main(argv + ["--out", str(tmp_path / "port")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert set(got) == set(want) and got["count"] == want["count"] == 4
    assert abs(got["psnr"] - want["psnr"]) <= 0.05 and abs(got["ssim"] - want["ssim"]) <= 1e-3
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "port"):
        a = read_png(str(tmp_path / "port" / name)).astype(int)
        b = read_png(str(tmp_path / "jax" / name)).astype(int)
        assert np.abs(a - b).max() <= 1, name
    limited = vqgan_recon.main(argv + ["--out", str(tmp_path / "lim"), "--limit", "2"])
    assert limited["count"] == 2 and len(os.listdir(tmp_path / "lim")) == 2


def test_tools_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        vqgan_recon.main(["--vq-ckpt", "x", "--data", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sampler_sweep.main(["--result", str(tmp_path)])


# ------------------------------------------------------------ sampler_sweep

def test_sampler_sweep_reports_resume_and_match_the_cli(tmp_path, monkeypatch, capsys):
    rs = np.random.RandomState(0)
    for stage, n in (("train", 1), ("val", 1), ("test", 4)):
        for side in "AB":
            os.makedirs(tmp_path / "data" / stage / side)
            for i in range(n):
                write_png(str(tmp_path / "data" / stage / side / f"p{i}.png"),
                          rs.randint(0, 256, (16, 16, 3)).astype(np.uint8))
    model = lbbdm_config()
    model.BB.params.num_timesteps = 40
    port = port_build(model, device="cpu", generator=torch.Generator().manual_seed(3))
    tree = jax_tree_from_state_dict(port)
    save_checkpoint({"model": tree, "step": 2, "epoch": 1}, str(tmp_path / "m.ckpt"))
    save_checkpoint({"vqgan": tree["vqgan"]}, str(tmp_path / "vq.ckpt"))
    cfg = {"runner": "BBDMRunner", "testing": {"clip_denoised": False, "sample_num": 2},
           "data": {"dataset_name": "tiny", "dataset_type": "custom_aligned",
                    "dataset_config": {"dataset_path": str(tmp_path / "data"), "image_size": 16,
                                       "channels": 3, "to_normal": True, "flip": False},
                    "train": {"batch_size": 2}, "val": {"batch_size": 2},
                    "test": {"batch_size": 2}},
           "model": model.to_dict()}
    save_config(dict2namespace(cfg), str(tmp_path / "tiny.yaml"))
    argv = ["--lbbdm-config", str(tmp_path / "tiny.yaml"), "--vq-ckpt", str(tmp_path / "vq.ckpt"),
            "--bridge-ckpt", str(tmp_path / "m.ckpt"), "--variants", "euler:5,heun:3",
            "--result", str(tmp_path / "sweep"), "--cpu"]
    rows = sampler_sweep.main(argv)
    assert [(r["sampler"], r["steps"], r["nfe"]) for r in rows] == [("euler", 5, 5),
                                                                     ("heun", 3, 5)]
    for r in rows:
        with open(tmp_path / "sweep" / f"report_{r['sampler']}{r['steps']}.json") as f:
            report = json.load(f)
        assert report["nfe"] == r["nfe"] and report["count"] == 4
        assert {"psnr", "ssim", "mse", "wall_sec_incl_compile"} <= set(report)
    capsys.readouterr()

    def no_runner(*a, **kw):
        raise AssertionError("a variant with a report ran again")

    with monkeypatch.context() as m:
        m.setattr("bbdm_tpu_torch.runners.get_runner", no_runner)
        again = sampler_sweep.main(argv)
    assert again == json.loads(json.dumps(rows))
    assert capsys.readouterr().out.count("report exists, skipping") == 2

    # the same overrides through main_torch.py --sample_to_eval
    args = sampler_sweep.parse_args(argv)
    for sampler, steps in (("euler", 5), ("heun", 3)):
        over = sampler_sweep.variant_config(args, sampler, steps)
        save_config(over, str(tmp_path / f"{sampler}.yaml"))
        main_torch.main(["-c", str(tmp_path / f"{sampler}.yaml"), "--sample_to_eval",
                         "--gpu_ids", "-1", "-r", str(tmp_path / "cli")])
        sub = os.path.join("tiny", f"sweep-{sampler}{steps}", "sample_to_eval")
        sweep_dir, cli_dir = tmp_path / "sweep" / sub, tmp_path / "cli" / sub
        names = sorted(os.listdir(sweep_dir / str(steps)))
        assert names == ["p0.png", "p1.png", "p2.png", "p3.png"]
        assert sorted(os.listdir(cli_dir / str(steps))) == names
        for n in names:
            np.testing.assert_array_equal(read_png(str(sweep_dir / str(steps) / n)),
                                          read_png(str(cli_dir / str(steps) / n)))
    assert load_config(str(tmp_path / "heun.yaml")).model.BB.params.sampler == "heun"
