"""The port's ``VQGANRunner`` and ``main_torch.py`` on a VQGAN config against
the JAX package's runner and ``main.py``, on the CPU.

* The CLI, both packages on one tiny config (ch 32 x (1, 2), 16^2 PNGs,
  PatchGAN ndf 8 with 2 layers, ``training.mesh_devices`` 1 for the JAX mesh):
  ``--train`` writes the same checkpoint files with trees of the same
  structure and counters; ``--sample_to_eval`` and the grid mode from one
  JAX-written checkpoint write the same PNG trees, each PNG within one uint8
  level (the reconstruction runs in eval mode: the subpixel up-conv).
* Checkpoints both ways: a port run's model and optimizer files resume in the
  JAX runner (its ``from_state_dict`` raises on any structural mismatch) with
  equal trees and the same eval loss (2e-4); a JAX run's files resume in the
  port with equal counters, weights, BatchNorm statistics and Adam states.
* A port-trained VQGAN loads as an LBBDM's first stage; a checkpoint converted
  with another discriminator geometry is refused by name; LPIPS weights are
  loaded (LPIPS-VGG, the perceptual term), as the JAX runner loads them.
* ``checkpoints/torch_import.py``'s taming-layout converters against the JAX
  package's on one synthetic state_dict, the LPIPS weights included.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from test_torch_cli import _NoAliases, files
from test_torch_import import _vqgan_torch_keys

import main as jax_main
import main_torch
from bbdm_tpu.checkpoints import io as jax_io
from bbdm_tpu.config import apply_cli_overrides as jax_overrides
from bbdm_tpu.config import load_config as jax_load_config
from bbdm_tpu.runners.vqgan import VQGANRunner as JaxRunner
from bbdm_tpu_torch.checkpoints import io
from bbdm_tpu_torch.checkpoints.from_jax import adam_state_to_jax, jax_tree_from_state_dict
from bbdm_tpu_torch.config import apply_cli_overrides, load_config, save_config
from bbdm_tpu_torch.runners.vqgan import VQGANRunner
from bbdm_tpu_torch.utils.images import read_png, write_png

MODEL = "vq-tiny"


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_trees_equal(a, b, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def structure(tree):
    if isinstance(tree, dict):
        return {k: structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [structure(v) for v in tree]
    return np.shape(tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A custom_single PNG dataset (4 train, 2 val, 3 test images, batch 2: the
    test split ends in a partial batch), the YAML config and a checkpoint of
    the JAX runner's initial weights."""
    root = tmp_path_factory.mktemp("vqgan")
    rs = np.random.RandomState(0)
    for stage, n in (("train", 4), ("val", 2), ("test", 3)):
        os.makedirs(root / "data" / stage)
        for i in range(n):
            write_png(str(root / "data" / stage / f"im{i}.png"),
                      rs.randint(0, 256, (16, 16, 3)).astype(np.uint8))
    cfg = {"runner": "VQGANRunner",
           "training": {"n_epochs": 2, "n_steps": 100, "save_interval": 1,
                        "sample_interval": 10, "validation_interval": 2,
                        "accumulate_grad_batches": 1, "mesh_devices": 1},
           "testing": {"clip_denoised": False, "sample_num": 1},
           "data": {"dataset_name": "tiny", "dataset_type": "custom_single",
                    "dataset_config": {"dataset_path": str(root / "data"), "image_size": 16,
                                       "channels": 3, "to_normal": True, "flip": False},
                    "train": {"batch_size": 2, "shuffle": True},
                    "val": {"batch_size": 2, "shuffle": True}, "test": {"batch_size": 2}},
           "model": {"model_name": MODEL, "model_type": "VQGAN", "mixed_precision": False,
                     "VQGAN": {"params": {
                         "embed_dim": 3, "n_embed": 32,
                         "ddconfig": {"double_z": False, "z_channels": 3, "resolution": 16,
                                      "in_channels": 3, "out_ch": 3, "ch": 32,
                                      "ch_mult": (1, 2), "num_res_blocks": 1,
                                      "attn_resolutions": [], "dropout": 0.0}}},
                     "loss": {"disc_start": 0, "disc_factor": 1.0, "disc_weight": 0.8,
                              "codebook_weight": 1.0, "perceptual_weight": 0.0,
                              "lpips_weights": None, "disc_loss": "hinge",
                              "adaptive_disc_weight": True, "use_actnorm": False,
                              "disc_ndf": 8, "disc_num_layers": 2},
                     "optimizer": {"lr": 1e-4, "beta1": 0.5}}}
    with open(root / "vq.yaml", "w") as f:
        yaml.dump(cfg, f, Dumper=_NoAliases)
    jr = jax_runner(str(root / "vq.yaml"), root / "init")
    model_states, _ = jr.get_checkpoint_states()
    jax_io.save_checkpoint(model_states, str(root / "m.ckpt"))
    return root


def argv_of(path, out, *extra):
    return ["-c", path, "--gpu_ids", "-1", "-r", str(out), *extra]


def jax_runner(path, out, *extra):
    return JaxRunner(jax_overrides(jax_load_config(path),
                                   main_torch.parse_args(argv_of(path, out, "--train", *extra))))


def port_runner(path, out, *extra):
    return VQGANRunner(apply_cli_overrides(load_config(path),
                                           main_torch.parse_args(argv_of(path, out, "--train",
                                                                         *extra))))


def run_jax(monkeypatch, argv):
    monkeypatch.setenv("BBDM_JAX_CACHE", "0")
    monkeypatch.setattr(sys, "argv", ["main.py"] + argv)
    jax_main.main()


def variant(setup, name, **loss):
    cfg = load_config(str(setup / "vq.yaml"))
    for k, v in loss.items():
        cfg.model.loss[k] = v
    path = str(setup / f"{name}.yaml")
    save_config(cfg, path)
    return path


def ckpt_dir(result):
    return os.path.join(str(result), "tiny", MODEL, "checkpoint")


def test_cli_train_writes_the_checkpoints_the_jax_cli_writes(setup, monkeypatch):
    """``--train`` over two epochs of two batches: the same checkpoint names,
    counters and tree structures in the model and optimizer files."""
    path = str(setup / "vq.yaml")
    run_jax(monkeypatch, argv_of(path, setup / "jax-train", "--train"))
    runner = main_torch.main(argv_of(path, setup / "port-train", "--train"))
    assert isinstance(runner, VQGANRunner) and runner.global_step == 4
    jck, pck = ckpt_dir(setup / "jax-train"), ckpt_dir(setup / "port-train")
    assert sorted(os.listdir(pck)) == sorted(os.listdir(jck))
    for name in ("last_model.ckpt", "last_optim_sche.ckpt", "latest_model_2.ckpt"):
        mine, theirs = jax_io.load_checkpoint(os.path.join(pck, name)), \
            jax_io.load_checkpoint(os.path.join(jck, name))
        assert structure(mine) == structure(theirs), name
        if "model" in name:
            assert (mine["step"], mine["epoch"]) == (theirs["step"], theirs["epoch"]) == (4, 2)
    trained = runner.model.vqgan.state_dict()
    for k, t in runner.model.vqgan.named_parameters():
        assert torch.isfinite(t).all(), k
    assert any(not torch.equal(trained[k], v) for k, v in VQGANRunner(
        apply_cli_overrides(load_config(path), main_torch.parse_args(
            argv_of(path, setup / "fresh")))).model.vqgan.state_dict().items())


@pytest.mark.parametrize("mode", ["sample_to_eval", "grid"])
def test_cli_reconstructions_match_the_jax_cli(setup, monkeypatch, mode):
    path = str(setup / "vq.yaml")
    argv = ["--resume_model", str(setup / "m.ckpt")] + (
        ["--sample_to_eval"] if mode == "sample_to_eval" else [])
    run_jax(monkeypatch, argv_of(path, setup / f"jax-{mode}", *argv))
    runner = main_torch.main(argv_of(path, setup / f"port-{mode}", *argv))
    assert runner.device.type == "cpu"
    jroot, proot = setup / f"jax-{mode}", setup / f"port-{mode}"
    got, want = files(proot), files(jroot)
    assert got == want
    base = os.path.join("tiny", MODEL)
    if mode == "sample_to_eval":
        assert {p for p in got if "reconstruction" in p} == {
            os.path.join(base, "sample_to_eval", "reconstruction", f"im{i}.png") for i in (0, 1)}
    else:
        grid = os.path.join(base, "samples", "0", "test_sample")
        assert {p for p in got if p.startswith(grid)} == {
            os.path.join(grid, f"{n}.png") for n in ("input", "reconstruction")}
    for p in (p for p in got if p.endswith(".png")):
        a, b = read_png(str(proot / p)), read_png(str(jroot / p))
        assert a.shape == b.shape and np.abs(a.astype(int) - b).max() <= 1, p


def batch_of(seed):
    return np.random.RandomState(seed).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)


def test_port_checkpoint_resumes_in_the_jax_runner(setup, tmp_path):
    path = str(setup / "vq.yaml")
    port = port_runner(path, tmp_path / "a")
    step = port.build_train_step()
    port.model.train()
    for i in range(2):
        x = port._to_device(batch_of(i))
        step(port.state, x, x, port.train_generator)
    port.global_epoch = 1
    model_states, optim_states = port.get_checkpoint_states()
    io.save_checkpoint(model_states, str(tmp_path / "m.ckpt"))
    io.save_checkpoint(optim_states, str(tmp_path / "o.ckpt"))

    jr = jax_runner(path, tmp_path / "b", "--resume_model", str(tmp_path / "m.ckpt"),
                    "--resume_optim", str(tmp_path / "o.ckpt"))
    assert (jr.global_epoch, jr.global_step, int(jr.state.step)) == (2, 2, 2)
    host = lambda t: jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(t))
    assert_trees_equal(host(jr.state.gen_params), model_states["model"]["vqgan"])
    assert_trees_equal(host(jr.state.disc_params), model_states["model"]["discriminator"])
    assert_trees_equal(host(jr.state.disc_stats), model_states["model"]["disc_stats"])
    assert_trees_equal(host(jr.state.gen_opt), optim_states["optimizer"][0])
    assert_trees_equal(host(jr.state.disc_opt), optim_states["optimizer"][1])
    x = batch_of(7)
    want = float(jr._eval_step(jr.state, x, x, jax.random.PRNGKey(0)))
    xt = port._to_device(x)
    assert abs(float(port.build_eval_step()(port.state, xt, xt)) - want) <= 2e-4
    assert port.model.vqgan.training  # the eval step restores the mode


def test_jax_checkpoint_resumes_in_the_port(setup, tmp_path):
    path = str(setup / "vq.yaml")
    jr = jax_runner(path, tmp_path / "a")
    for i in range(2):
        jr.state, _ = jr._train_step(jr.state, batch_of(i), batch_of(i), jax.random.PRNGKey(i))
    jr.global_step, jr.global_epoch = 2, 0
    model_states, optim_states = jr.get_checkpoint_states()
    jax_io.save_checkpoint(model_states, str(tmp_path / "m.ckpt"))
    jax_io.save_checkpoint(optim_states, str(tmp_path / "o.ckpt"))

    port = port_runner(path, tmp_path / "b", "--resume_model", str(tmp_path / "m.ckpt"),
                       "--resume_optim", str(tmp_path / "o.ckpt"))
    assert (port.global_epoch, port.global_step, port.state.step) == (1, 2, 2)
    mine, optim = port.get_checkpoint_states("graceful_stop")
    want, want_o = (jax_io.load_checkpoint(str(tmp_path / n)) for n in ("m.ckpt", "o.ckpt"))
    assert_trees_equal(mine["model"], want["model"])
    assert_trees_equal(optim["optimizer"], want_o["optimizer"])
    assert_trees_equal(adam_state_to_jax(port.state.disc_opt), want_o["optimizer"][1])


def test_a_port_trained_vqgan_loads_as_an_lbbdm_first_stage(setup, tmp_path):
    """The VQGAN runner's model file as ``VQGAN.params.ckpt_path`` of an LBBDM:
    the first stage holds exactly its autoencoder and encodes like it."""
    from test_latent import lbbdm_config

    from bbdm_tpu_torch.config import dict2namespace
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    path = str(setup / "vq.yaml")
    port = port_runner(path, tmp_path / "a")
    port.model.train()
    x = port._to_device(batch_of(3))
    port.build_train_step()(port.state, x, x, port.train_generator)
    io.save_checkpoint(port.get_checkpoint_states()[0], str(tmp_path / "vq.ckpt"))

    lb = lbbdm_config("nocond").to_dict()  # its first stage is the config's autoencoder
    lb["VQGAN"]["params"]["ckpt_path"] = str(tmp_path / "vq.ckpt")
    lbbdm = BBDMRunner(dict2namespace({"model": lb}), device="cpu")
    assert_trees_equal(jax_tree_from_state_dict(lbbdm.model.vqgan),
                       jax_tree_from_state_dict(port.model.vqgan))
    port.model.vqgan.eval()
    with torch.no_grad():
        torch.testing.assert_close(lbbdm.model.encode(x, normalize=False),
                                   port.model.vqgan.encode_latent(x), rtol=0, atol=0)


def test_another_discriminator_geometry_and_lpips_weights_are_refused(setup, tmp_path):
    """Another discriminator geometry is refused by name. LPIPS weights are no
    longer refused: both runners load LPIPS-VGG from ``lpips_weights`` and log
    the same line (``test_torch_vqgan_perceptual.py`` holds the term)."""
    from test_torch_eval_metrics import random_lpips

    ck = jax_io.load_checkpoint(str(setup / "m.ckpt"))
    ck["disc_config"] = {"disc_num_layers": 3, "use_actnorm": False, "disc_ndf": 8}
    io.save_checkpoint(ck, str(tmp_path / "conv.ckpt"))
    with pytest.raises(ValueError, match="disc_num_layers"):
        port_runner(str(setup / "vq.yaml"), tmp_path / "a", "--resume_model",
                    str(tmp_path / "conv.ckpt"))
    torch.save(random_lpips("vgg").state_dict(), str(tmp_path / "lpips_vgg.pth"))
    path = variant(setup, "lpips", lpips_weights=str(tmp_path / "lpips_vgg.pth"),
                   perceptual_weight=1.0)
    logs = []
    for make in (port_runner, jax_runner):
        runner = make(path, tmp_path / make.__name__)
        runner.logger = logs.append
        runner.build_train_step()
    line = f"perceptual loss enabled (LPIPS weights: {tmp_path / 'lpips_vgg.pth'})"
    assert logs.count(line) == 2, logs


@pytest.mark.parametrize("use_actnorm", [False, True])
def test_taming_checkpoint_converters_match_the_jax_ones(tmp_path, use_actnorm):
    """A taming-layout training checkpoint (autoencoder, ``loss.discriminator
    .main.*``, ``loss.perceptual_loss.*`` with taming's LPIPS-VGG names): the
    port's converters give the JAX converters' trees, the LPIPS tree included."""
    from bbdm_tpu.checkpoints import torch_import as jti
    from bbdm_tpu_torch.checkpoints import torch_import as pti

    rs = np.random.RandomState(4)
    sd = _vqgan_torch_keys(32, (1, 2), 1, 3, 3, 32, 16)
    del sd["loss.dummy"]
    chans = [3, 8, 16, 32]
    main = {"main.0.weight": rs.randn(8, 3, 4, 4), "main.0.bias": rs.randn(8)}
    for n in range(1, 3):
        main[f"main.{2 + (n - 1) * 3}.weight"] = rs.randn(chans[n + 1], chans[n], 4, 4)
        norm = f"main.{3 + (n - 1) * 3}"
        if use_actnorm:
            main[f"{norm}.loc"] = rs.randn(1, chans[n + 1], 1, 1)
            main[f"{norm}.scale"] = rs.randn(1, chans[n + 1], 1, 1)
        else:
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                main[f"{norm}.{leaf}"] = rs.randn(chans[n + 1])
    main["main.8.weight"], main["main.8.bias"] = rs.randn(1, 32, 4, 4), rs.randn(1)
    sd.update({f"loss.discriminator.{k}": torch.from_numpy(v.astype(np.float32))
               for k, v in main.items()})
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    from test_torch_eval_metrics import random_lpips

    lp_sd = {("scaling_layer." + k if k in ("shift", "scale") else k): v
             for k, v in random_lpips("vgg").state_dict().items()}  # taming's LPIPS names
    sd.update({f"loss.perceptual_loss.{k}": v for k, v in lp_sd.items()})
    torch.save({"state_dict": sd}, str(tmp_path / "taming.ckpt"))

    got, lpips = pti.convert_vqgan_train_checkpoint(str(tmp_path / "taming.ckpt"))
    want, want_lpips = jti.convert_vqgan_train_checkpoint(str(tmp_path / "taming.ckpt"))
    assert got["disc_config"] == want["disc_config"] == {
        "disc_num_layers": 2, "use_actnorm": use_actnorm, "disc_ndf": 8}
    if use_actnorm:
        assert got["model"]["disc_stats"] is None and want["model"]["disc_stats"] is None
    assert_trees_equal({k: v for k, v in got["model"].items() if v is not None},
                       {k: v for k, v in want["model"].items() if v is not None})
    assert_trees_equal(lpips, want_lpips)
    assert set(lpips) == {f"conv_{i}" for i in (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26,
                                                28)} | {f"lin_{k}" for k in range(5)}
