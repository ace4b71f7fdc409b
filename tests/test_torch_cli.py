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


def variant(setup, name, **training):
    """tiny.yaml with ``training`` keys set, written as ``<name>.yaml``."""
    from bbdm_tpu_torch.config import load_config, save_config

    cfg = load_config(str(setup / "tiny.yaml"))
    for k, v in training.items():
        cfg.training[k] = v
    path = str(setup / f"{name}.yaml")
    save_config(cfg, path)
    return path


def ckpt_dir(result):
    return os.path.join(result, "tiny", "tiny-lbbdm", "checkpoint")


def test_profile_dir_writes_a_trace(setup):
    """``training.profile_dir``: a chrome trace of the steps after
    ``profile_start_step`` (``profile_steps`` of them), written when the window
    closes, with the train step's operators in it."""
    import json

    from test_torch_parallel import one_thread

    prof = setup / "prof"
    with one_thread():
        runner = main_torch.main(["-c", variant(setup, "profile", profile_dir=str(prof),
                                                profile_start_step=1, profile_steps=1,
                                                n_steps=10, sample_interval=100,
                                                save_interval=3, validation_interval=3),
                                  "--train", "--max_epoch", "3", "--gpu_ids", "-1",
                                  "-r", str(setup / "train-prof")])
    assert runner.global_step == 3
    assert sorted(os.listdir(prof)) == ["steps_2-2.pt.trace.json"]
    with open(prof / "steps_2-2.pt.trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("conv" in n for n in names) and any("backward" in n.lower() for n in names)


def train_variant(setup, name, **training):
    return main_torch.main(["-c", variant(setup, name, **training), "--train", "--gpu_ids", "-1",
                            "-r", str(setup / name)])


@pytest.mark.parametrize("key,value", [("model_parallel", 2), ("fsdp", True)])
def test_sharded_training_on_one_rank(setup, key, value):
    """``model_parallel`` 2 on one rank raises ValueError naming 1 and 2, as
    JAX's ``make_mesh`` does over one device; ``fsdp`` on one rank is a data
    width of 1, which JAX replicates (``bbdm_tpu/parallel/tp.py:75-77``): the
    run writes the checkpoint a run without the key writes."""
    from bbdm_tpu.checkpoints.io import load_checkpoint as jax_load
    from bbdm_tpu.parallel import make_mesh
    from test_torch_parallel import one_thread

    if key == "model_parallel":
        match = "1 devices not divisible by model_parallel=2"
        with pytest.raises(ValueError, match=match):
            make_mesh(jax.devices()[:1], model_parallel=2)
        with pytest.raises(ValueError, match=match):
            train_variant(setup, "mp2", model_parallel=value)
        return
    with one_thread():
        runners = [train_variant(setup, "fsdp1", fsdp=value), train_variant(setup, "plain1")]
    assert [r.state.sharding for r in runners] == [None, None]
    for name in ("last_model.ckpt", "last_optim_sche.ckpt"):
        got, want = (jax_load(os.path.join(ckpt_dir(str(setup / n)), name))
                     for n in ("fsdp1", "plain1"))
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)


def test_mesh_devices_that_disagree_with_the_ranks_raise(setup):
    """``training.mesh_devices``, the JAX mesh's width, against the one rank of
    the run (``mesh_devices: 1`` agrees: the other tests here)."""
    with pytest.raises(ValueError, match=r"mesh_devices=2 but the run has 1 ranks"):
        train_variant(setup, "mesh2", mesh_devices=2)


def test_debug_nan_raises_at_the_first_non_finite_loss(setup, monkeypatch):
    """``training.debug_nan`` with the loss forced to NaN: the port raises
    FloatingPointError naming step 1 (before the backward; anomaly mode off
    again after it), and so does the JAX runner (``jax_debug_nans``, reset
    here after it)."""
    import jax.numpy as jnp

    from bbdm_tpu.models.latent import LatentBrownianBridgeModel as JaxLBBDM
    from bbdm_tpu_torch.models.latent import LatentBrownianBridgeModel as PortLBBDM

    port_loss = PortLBBDM.loss
    monkeypatch.setattr(PortLBBDM, "loss", lambda self, x, y, *a, **kw:
                        (port_loss(self, x, y, *a, **kw)[0] * float("nan"), {}))
    path = variant(setup, "nan", debug_nan=True, mesh_devices=1)
    with pytest.raises(FloatingPointError, match="non-finite loss at step 1"):
        main_torch.main(["-c", path, "--train", "--gpu_ids", "-1", "-r", str(setup / "nan")])
    assert not torch.is_anomaly_enabled()
    monkeypatch.setattr(JaxLBBDM, "loss", lambda self, params, rng, x, y, *a, **kw:
                        (jnp.nan * jnp.mean(x), {}))
    try:
        with pytest.raises(FloatingPointError, match="nan"):
            run_jax(monkeypatch, ["-c", path, "--train", "--gpu_ids", "-1", "-r",
                                  str(setup / "nan-jax")])
    finally:
        jax.config.update("jax_debug_nans", False)


def test_train_writes_the_checkpoints_the_jax_cli_writes(setup, monkeypatch):
    """``--train --save_top`` over two epochs (save_interval 1) through both
    CLIs on the same config: the same checkpoint file names
    (``bbdm_tpu/runners/base.py:599-625``: the first epoch's ``latest_*_1``
    removed, ``latest_*_2``, ``last_*``, the top pair), the same counters in
    them, and each model file's trees of the same structure; then the port
    resumes from its own ``last_*`` files for a third epoch. (``mesh_devices``
    1: the JAX runner's mesh of one of the 8 test devices; the port's one
    rank.)"""
    path = variant(setup, "train2", mesh_devices=1)
    argv = ["-c", path, "--train", "--gpu_ids", "-1", "--save_top", "--max_epoch", "2",
            "--max_steps", "10"]
    run_jax(monkeypatch, argv + ["-r", str(setup / "jax-train")])
    runner = main_torch.main(argv + ["-r", str(setup / "port-train")])
    assert runner.stop_reason is None and runner.global_step == 2
    jax_ck, port_ck = ckpt_dir(str(setup / "jax-train")), ckpt_dir(str(setup / "port-train"))
    # the top pair's epoch is the one of the lower val loss, which the two
    # frameworks' random draws decide differently
    top = lambda n: n.split("_epoch_")[0] if n.startswith("top_") else n
    names = sorted(os.listdir(port_ck))
    assert sorted(map(top, names)) == sorted(map(top, os.listdir(jax_ck)))
    assert {"latest_model_2.ckpt", "latest_optim_sche_2.ckpt", "last_model.ckpt",
            "last_optim_sche.ckpt"} <= set(names) and "latest_model_1.ckpt" not in names
    assert len([n for n in names if n.startswith("top_")]) == 2

    from bbdm_tpu.checkpoints.io import load_checkpoint as jax_load

    def structure(tree):
        return {k: structure(v) for k, v in tree.items()} if isinstance(tree, dict) else \
            np.shape(tree)

    for name in ("last_model.ckpt", "latest_model_2.ckpt"):
        mine, theirs = jax_load(os.path.join(port_ck, name)), jax_load(os.path.join(jax_ck, name))
        assert (mine["step"], mine["epoch"]) == (theirs["step"], theirs["epoch"]) == (2, 2)
        assert structure(mine) == structure(theirs)
    mine = jax_load(os.path.join(port_ck, "last_optim_sche.ckpt"))
    theirs = jax_load(os.path.join(jax_ck, "last_optim_sche.ckpt"))
    assert structure(mine) == structure(theirs)

    resumed = main_torch.main(["-c", path, "--train", "--gpu_ids", "-1", "--max_epoch", "3",
                               "--max_steps", "10", "-r", str(setup / "port-train"),
                               "--resume_model", os.path.join(port_ck, "last_model.ckpt"),
                               "--resume_optim", os.path.join(port_ck, "last_optim_sche.ckpt")])
    assert (resumed.global_epoch, resumed.global_step) == (2, 3)
    last = jax_load(os.path.join(port_ck, "last_model.ckpt"))
    assert (last["step"], last["epoch"]) == (3, 3)


def test_train_stops_gracefully_on_its_wall_budget(setup):
    """``training.max_wall_sec`` 0: the first step boundary ends training with a
    latest + last save that redoes the partial epoch on resume, and a normal
    return."""
    result = str(setup / "wall")
    runner = main_torch.main(["-c", variant(setup, "wall", max_wall_sec=0), "--train",
                              "--gpu_ids", "-1", "--max_epoch", "2", "-r", result])
    assert runner.stop_reason.startswith("wall budget")
    from bbdm_tpu.checkpoints.io import load_checkpoint as jax_load

    last = jax_load(os.path.join(ckpt_dir(result), "last_model.ckpt"))
    assert (last["step"], last["epoch"]) == (1, 0)


def test_train_saves_and_raises_on_an_exception(setup, monkeypatch):
    """An exception in the loop saves ``last_*`` (the exception save) and
    propagates, so the process exits non-zero."""
    from bbdm_tpu_torch.runners.base import BaseRunner

    def broken(self, *a):
        raise RuntimeError("sample failed")

    monkeypatch.setattr(BaseRunner, "sample_step", broken)
    result = str(setup / "exc")
    with pytest.raises(RuntimeError, match="sample failed"):
        main_torch.main(["-c", str(setup / "tiny.yaml"), "--train", "--gpu_ids", "-1",
                         "-r", result])
    assert sorted(os.listdir(ckpt_dir(result))) == ["config.yaml", "last_model.ckpt",
                                                    "last_optim_sche.ckpt"]


@pytest.mark.parametrize("gpu_ids,match", [("0,-1", "mixed"), ("0,0", "twice")])
def test_several_gpu_ids_raise(setup, gpu_ids, match):
    """-1 among card ids and a repeated id raise before any rank starts."""
    with pytest.raises(ValueError, match=match):
        main_torch.main(["-c", str(setup / "tiny.yaml"), "--sample_to_eval", "--gpu_ids",
                         gpu_ids, "-r", str(setup / "multi")])


def test_several_gpu_ids_need_the_cards(setup, monkeypatch):
    """``--gpu_ids 0,1`` names one rank per card; without a card it raises before
    starting them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("torch.multiprocessing.spawn", lambda *a, **k: pytest.fail("spawned"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main_torch.main(["-c", str(setup / "tiny.yaml"), "--sample_to_eval", "--gpu_ids", "0,1",
                         "-r", str(setup / "multi")])


def test_without_a_card_the_cli_raises(setup, monkeypatch):
    """No CPU fallback: without --gpu_ids -1 and with the card hidden, it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main_torch.main(["-c", str(setup / "tiny.yaml"), "--sample_to_eval",
                         "-r", str(setup / "nocard")])
