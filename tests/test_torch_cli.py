"""``main_torch.py`` against the JAX package's ``main.py`` on the same tiny
config, checkpoint and PNG dataset, both on the CPU: the same result tree, each
PNG within one uint8 level (eta 0, so no draw reaches the output)."""

import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml
from test_latent import lbbdm_config

import main as jax_main
import main_torch
from bbdm_tpu.checkpoints.io import save_checkpoint
from bbdm_tpu.models import build_model as jax_build
from bbdm_tpu_torch.utils.images import read_png, write_png


class _NoAliases(yaml.SafeDumper):
    def ignore_aliases(self, data):
        return True


_NoAliases.add_representer(
    tuple, lambda d, t: d.represent_sequence("tag:yaml.org,2002:python/tuple", t))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny LBBDM (SpatialRescaler condition, eta 0, 2 draws) as a YAML with
    ``!!python/tuple`` lists, a JAX-written checkpoint whose model and ema
    differ, the frozen VQGAN alone, and a custom_aligned PNG dataset whose test
    split (5 pairs, batch 2) ends in a partial batch."""
    root = tmp_path_factory.mktemp("cli")
    rs = np.random.RandomState(0)
    for stage, n in (("train", 2), ("val", 2), ("test", 5)):
        for side in "AB":
            os.makedirs(root / "data" / stage / side)
            for i in range(n):
                write_png(str(root / "data" / stage / side / f"p{i}.png"),
                          rs.randint(0, 256, (16, 16, 3)).astype(np.uint8))
    model = lbbdm_config("SpatialRescaler")
    model.BB.params.eta = 0.0
    jm = jax_build(model)
    params, ema = (jax.tree_util.tree_map(np.asarray, jax.jit(jm.init_params)(
        jax.random.PRNGKey(s))) for s in (0, 1))
    ema["vqgan"] = params["vqgan"]
    save_checkpoint({"model": params, "ema": ema, "step": 4, "epoch": 1}, str(root / "m.ckpt"))
    save_checkpoint({"vqgan": params["vqgan"]}, str(root / "vq.ckpt"))
    d = model.to_dict()
    d["VQGAN"]["params"]["ckpt_path"] = str(root / "vq.ckpt")
    d["EMA"] = {"use_ema": True, "ema_decay": 0.9, "update_ema_interval": 1,
                "start_ema_step": 0}
    cfg = {"runner": "BBDMRunner",
           "training": {"n_epochs": 1, "n_steps": 1, "save_interval": 1, "sample_interval": 1,
                        "validation_interval": 1, "accumulate_grad_batches": 1},
           "testing": {"clip_denoised": False, "sample_num": 2},
           "data": {"dataset_name": "tiny", "dataset_type": "custom_aligned",
                    "dataset_config": {"dataset_path": str(root / "data"), "image_size": 16,
                                       "channels": 3, "to_normal": True, "flip": False},
                    "train": {"batch_size": 2, "shuffle": True},
                    "val": {"batch_size": 2, "shuffle": True}, "test": {"batch_size": 2}},
           "model": d}
    with open(root / "tiny.yaml", "w") as f:
        yaml.dump(cfg, f, Dumper=_NoAliases)
    return root


def run_jax(monkeypatch, argv):
    monkeypatch.setenv("BBDM_JAX_CACHE", "0")
    monkeypatch.setattr(sys, "argv", ["main.py"] + argv)
    jax_main.main()


def files(root):
    """Relative paths of every file under root, the JAX TensorBoard event file
    (a timestamped name) left out."""
    out = set()
    for d, _, names in os.walk(root):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), root)
            if not os.path.basename(rel).startswith("events.out.tfevents"):
                out.add(rel)
    return out


@pytest.mark.parametrize("mode", ["sample_to_eval", "grid"])
def test_cli_writes_the_jax_tree(setup, monkeypatch, mode):
    root = setup
    argv = ["-c", str(root / "tiny.yaml"), "--resume_model", str(root / "m.ckpt"),
            "--gpu_ids", "-1"] + (["--sample_to_eval"] if mode == "sample_to_eval" else [])
    run_jax(monkeypatch, argv + ["-r", str(root / f"jax-{mode}")])
    runner = main_torch.main(argv + ["-r", str(root / f"port-{mode}")])
    assert runner.device.type == "cpu" and (runner.global_epoch, runner.global_step) == (1, 4)

    jax_root, port_root = root / f"jax-{mode}", root / f"port-{mode}"
    got, want = files(port_root), files(jax_root)
    assert got == want
    base = os.path.join("tiny", "tiny-lbbdm")
    if mode == "sample_to_eval":
        step = str(lbbdm_config().BB.params.sample_step)
        assert os.path.join(base, "sample_to_eval", step, "p3", "output_1.png") in got
        assert not any("p4" in p for p in got)  # the partial last batch is dropped
    else:
        grid = os.path.join(base, "samples", "0", "test_sample")
        assert {p for p in got if p.startswith(grid)} == {
            os.path.join(grid, f"{n}.png") for n in ("skip_sample", "condition", "ground_truth")}
    assert os.path.join(base, "checkpoint", "config.yaml") in got
    pngs = [p for p in got if p.endswith(".png")]
    assert pngs
    for p in pngs:
        a, b = read_png(str(port_root / p)), read_png(str(jax_root / p))
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b).max() <= 1, p
    with open(port_root / base / "checkpoint" / "config.yaml") as f:
        written = yaml.safe_load(f)
    assert written["model"]["model_load_path"] == str(root / "m.ckpt")


def test_train_raises(setup):
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md §1 item 4"):
        main_torch.main(["-c", str(setup / "tiny.yaml"), "--train", "--gpu_ids", "-1",
                         "-r", str(setup / "train")])


def test_several_gpu_ids_raise(setup):
    with pytest.raises(NotImplementedError, match="data-parallel"):
        main_torch.main(["-c", str(setup / "tiny.yaml"), "--sample_to_eval", "--gpu_ids", "0,1",
                         "-r", str(setup / "multi")])


def test_without_a_card_the_cli_raises(setup, monkeypatch):
    """No CPU fallback: without --gpu_ids -1 and with the card hidden, it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main_torch.main(["-c", str(setup / "tiny.yaml"), "--sample_to_eval",
                         "-r", str(setup / "nocard")])
