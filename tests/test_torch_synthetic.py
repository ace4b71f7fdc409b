"""The port's host tools against the JAX repo's scripts, on the CPU. Each script
of ``scripts/`` is imported as a module, as ``tests/test_chain_demo.py`` does.

* ``tools/synthetic.py`` against ``scripts/make_synthetic_dataset.py``:
  ``make_pair`` bit for bit for the three tasks, several seeds, at 32^2 and
  256^2; the files of ``write_stage`` (A, B, and the stochastic task's
  ``B_modes``) decoded with Pillow equal to the script's Pillow files, name for
  name; the CLI's three stages.
* ``tools/stochastic_demo.score_mode_tree`` returns the script's dict on one
  tree (committed, averaged and noisy draws).
* ``tools/read_tboard.py`` against ``scripts/read_tboard.py``: the same rows and
  the same printed CSV over event files from both packages' writers (scalars
  and an image).
* ``tools/random_{inception,lpips}.py`` against ``scripts/make_random_*.py``
  at the same seed: the weights each package's loader reads from its own
  file are equal, and the port's InceptionV3 features and LPIPS distances on
  those weights are within 1e-5 (features: of each image's feature norm;
  distances: relative) of the JAX package's networks on the JAX file.
"""

import os
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_parallel import one_thread

from bbdm_tpu.evaluation.fid import load_fid_params as jax_load_fid_params
from bbdm_tpu.evaluation.inception import FIDInceptionV3 as JaxInception
from bbdm_tpu.evaluation.lpips import load_lpips_params as jax_load_lpips_params
from bbdm_tpu.evaluation.lpips import lpips_distance
from bbdm_tpu.utils.tboard import SummaryWriter as JaxWriter
from bbdm_tpu_torch.evaluation.fid import load_fid_model, load_fid_params
from bbdm_tpu_torch.evaluation.inception import state_dict_from_inception_tree
from bbdm_tpu_torch.evaluation.lpips import (
    load_lpips,
    load_lpips_params,
    state_dict_from_lpips_tree,
)
from bbdm_tpu_torch.tools import random_inception, random_lpips, read_tboard, synthetic
from bbdm_tpu_torch.tools.stochastic_demo import score_mode_tree
from bbdm_tpu_torch.utils.tboard import SummaryWriter as PortWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import eval_stochastic_demo as jax_stoch  # noqa: E402
import make_synthetic_dataset as jax_syn  # noqa: E402
import read_tboard as jax_tboard  # noqa: E402

TASKS = ("colorization", "restore", "stochastic")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_thread():
        yield


def pillow(path):
    return np.asarray(Image.open(path))


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


# ---------------------------------------------------------------- synthetic

@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("size,seeds", [(32, (0, 1, 7, 1_000_003)), (256, (2_000_001,))])
def test_make_pair_equals_the_script(task, size, seeds):
    for seed in seeds:
        want = jax_syn.make_pair(seed, size, task=task, blur_sigma=4.0 if size == 256 else 0.5)
        got = synthetic.make_pair(seed, size, task=task, blur_sigma=4.0 if size == 256 else 0.5)
        assert len(got) == len(want) == (3 if task == "stochastic" else 2)
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype == np.uint8 and g.shape == (size, size, 3)
            np.testing.assert_array_equal(g, w)
        if task == "stochastic":
            assert len(got[2]) == 4
            for g, w in zip(got[2], want[2]):
                np.testing.assert_array_equal(g, w)


def test_unknown_task_raises():
    with pytest.raises(ValueError, match="unknown task"):
        synthetic.make_pair(0, 8, task="denoise")


@pytest.mark.parametrize("task,stage", [("restore", "train"), ("colorization", "val"),
                                        ("stochastic", "test"), ("stochastic", "train")])
def test_write_stage_files_decode_as_the_scripts(tmp_path, capsys, task, stage):
    for side, mod in (("jax", jax_syn), ("port", synthetic)):
        mod.write_stage(str(tmp_path / side), stage, 3, 32, 11, task=task, blur_sigma=0.5)
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("/jax/", "/port/") == out[1]
    files = tree_files(tmp_path / "jax")
    assert files == tree_files(tmp_path / "port")
    assert len(files) == 6 + (12 if task == "stochastic" and stage != "train" else 0)
    for f in files:
        want, got = pillow(tmp_path / "jax" / f), pillow(tmp_path / "port" / f)
        assert got.dtype == want.dtype and got.shape == want.shape == (32, 32, 3), f
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_synthetic_cli_writes_three_stages(tmp_path, monkeypatch):
    argv = ["--size", "16", "--train", "2", "--val", "1", "--test", "1", "--seed", "5",
            "--task", "stochastic", "--blur-sigma", "0.5"]
    monkeypatch.setattr(sys, "argv", ["make_synthetic_dataset.py", "--out",
                                      str(tmp_path / "jax")] + argv)
    jax_syn.main()
    synthetic.main(["--out", str(tmp_path / "port"), "--cpu"] + argv)
    files = tree_files(tmp_path / "port")
    assert files == tree_files(tmp_path / "jax")
    assert "val/B_modes/val_00000_m3.png" in files and "train/B/train_00001.png" in files
    for f in files:
        np.testing.assert_array_equal(pillow(tmp_path / "port" / f),
                                      pillow(tmp_path / "jax" / f), err_msg=f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        synthetic.main(["--out", str(tmp_path / "card")] + argv)
    assert not (tmp_path / "card").exists()


# ---------------------------------------------------------- score_mode_tree

def test_score_mode_tree_equals_the_script(tmp_path):
    modes_dir, cond_dir, result_dir = (tmp_path / d for d in ("modes", "cond", "result"))
    for d in (modes_dir, cond_dir):
        os.makedirs(d)
    rs = np.random.RandomState(4)
    for i in range(3):
        a, _, modes = synthetic.make_pair(40 + i, 32, task="stochastic", blur_sigma=0.5)
        name = f"test_{i:05d}"
        Image.fromarray(a).save(cond_dir / f"{name}.png")
        for k, m in enumerate(modes):
            Image.fromarray(m).save(modes_dir / f"{name}_m{k}.png")
        os.makedirs(result_dir / name)
        avg = ((modes[i].astype(np.float64) + modes[(i + 1) % 4]) / 2).astype(np.uint8)
        noisy = np.clip(modes[3 - i].astype(int) + rs.randint(-20, 21, modes[0].shape),
                        0, 255).astype(np.uint8)
        for j, img in enumerate((modes[i], avg, noisy)):
            Image.fromarray(img).save(result_dir / name / f"output_{j}.png")
    args = (str(result_dir), str(modes_dir), str(cond_dir), 3)
    want, got = jax_stoch.score_mode_tree(*args), score_mode_tree(*args)
    assert got == want
    assert got["images"] == 3 and sum(got["mode_histogram"]) == 9


# -------------------------------------------------------------- read_tboard

def write_events(log_dir, writer_cls, offset):
    w = writer_cls(str(log_dir))
    for step in range(1, 6):
        w.add_scalar("loss/train", 0.5 / step + offset, step)
        if step % 2 == 0:
            w.add_scalar("loss/val_step", 0.25 / step + offset, step)
    w.add_image("train_sample", np.full((4, 6, 3), 7, np.uint8), 3)
    w.add_scalar("val_epoch/loss", 0.125 + offset, 0)
    w.close()


def test_read_tboard_equals_the_script(tmp_path, monkeypatch, capsys):
    write_events(tmp_path / "logs" / "jax", JaxWriter, 0.0)
    write_events(tmp_path / "logs" / "port", PortWriter, 1.0)
    root = str(tmp_path / "logs")
    want = list(jax_tboard.read_dir(root))
    assert list(read_tboard.read_dir(root)) == want
    assert len(want) == 16 and {r[0] for r in want} == {"loss/train", "loss/val_step",
                                                        "val_epoch/loss"}
    for prefix in ([], ["loss/"]):
        monkeypatch.setattr(sys, "argv", ["read_tboard.py", root] + prefix)
        jax_tboard.main()
        printed = capsys.readouterr().out
        rows = read_tboard.main([root] + prefix + ["--cpu"])
        assert capsys.readouterr().out == printed
        assert len(rows) == len(printed.splitlines()) - 1
    one = str(next((tmp_path / "logs" / "port").iterdir()))
    assert list(read_tboard.read_dir(one)) == list(jax_tboard.read_dir(one))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        read_tboard.main([root])


def test_read_tboard_stops_at_a_cut_record(tmp_path):
    write_events(tmp_path, PortWriter, 0.0)
    path = next(tmp_path.iterdir())
    data = path.read_bytes()
    path.write_bytes(data[:-10])
    rows = list(read_tboard.read_dir(str(path)))
    assert rows == list(jax_tboard.read_dir(str(path))) and len(rows) == 7


# ------------------------------------------------------- random backbones

def run_script(monkeypatch, script, argv):
    monkeypatch.setattr(sys, "argv", [script] + argv)
    runpy.run_path(os.path.join(REPO, "scripts", script), run_name="__main__")


@pytest.mark.parametrize("seed", [3, 8])
def test_random_lpips_matches_the_script(tmp_path, monkeypatch, seed):
    run_script(monkeypatch, "make_random_lpips.py",
               ["--out", str(tmp_path / "jax.ckpt"), "--seed", str(seed)])
    port_file = random_lpips.main(["--out", str(tmp_path / "port.pth"), "--seed", str(seed),
                                   "--cpu"])
    tree = jax_load_lpips_params(str(tmp_path / "jax.ckpt"), "alex")
    mine = load_lpips_params(port_file, "alex")
    theirs = state_dict_from_lpips_tree(tree, "alex")
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        torch.testing.assert_close(mine[k], theirs[k], rtol=0, atol=0, msg=k)
    assert all((mine[f"lin{k}.model.1.weight"] >= 0).all() for k in range(5))
    rs = np.random.RandomState(seed)
    a, b = (rs.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(lpips_distance(tree, "alex", jnp.asarray(a), jnp.asarray(b)))
    model = load_lpips(port_file, "alex", device="cpu")
    nchw = lambda x: torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        got = model(nchw(a), nchw(b)).numpy()
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_random_inception_matches_the_script(tmp_path, monkeypatch):
    run_script(monkeypatch, "make_random_inception.py",
               ["--out", str(tmp_path / "jax.pth"), "--seed", "3"])
    port_file = random_inception.main(["--out", str(tmp_path / "port.pth"), "--cpu"])
    tree = jax_load_fid_params(str(tmp_path / "jax.pth"))
    mine = load_fid_params(port_file)
    theirs = state_dict_from_inception_tree(tree)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        torch.testing.assert_close(mine[k], theirs[k], rtol=0, atol=0, msg=k)
    x = np.random.RandomState(0).rand(2, 75, 75, 3).astype(np.float32)
    want = np.asarray(JaxInception(resize_input=False).apply({"params": tree}, jnp.asarray(x)))
    model = load_fid_model(port_file, device="cpu")
    model.resize_input = False
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert got.shape == want.shape == (2, 2048)
    norm = np.linalg.norm(want, axis=1)
    assert (norm > 1e-3).all() and np.isfinite(got).all()
    err = np.linalg.norm(got - want, axis=1) / norm
    assert (err <= 1e-5).all(), err


def test_random_backbones_raise_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (random_inception, random_lpips):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tool.main(["--out", str(tmp_path / "w.pth")])
    assert not (tmp_path / "w.pth").exists()
