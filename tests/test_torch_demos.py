"""The port's demonstration tools and parity protocol end to end on the CPU
(``bbdm_tpu_torch/tools/{pixel_demo,stochastic_demo,chain_demo,run_parity}.py``),
held against their scripts in ``scripts/``.

Each demo runs on the repo's CPU smoke configs
(``configs/runs/{BBDM,BBDM-stoch,VQGAN,LBBDM}-smoke-cpu.yaml``, unchanged: the
test runs from a directory whose ``datasets/`` holds the ``tools.synthetic``
trees they name) and must:

* write reports with the keys the JAX script writes (read from the script's
  source: the dict literals of its ``write_report`` calls, and for the
  stochastic demo the dict ``score_mode_tree`` returns);
* write no report when the stop file cuts its training short (the checkpoint
  of the graceful stop is written, and the next invocation resumes from it);
* skip a phase not started by ``--deadline-ts``, writing nothing for it;
* skip every phase that has a report on a rerun (no runner is built), and
  return the same rows.

The launch counts ``chip_smoke.py`` phase 14 holds the demos to come from
``chip_smoke.kernel_calls`` on their run configs: equal to the JAX modules'
calls (``tests/test_torch_latent_configs.jax_kernel_calls``) under the CUDA
dispatch's rule for the chain's LBBDM-f4 and the demos' pixel BBDM (no first
stage).

``run_parity`` runs on a reference-layout ``.pth`` (the UNet, VQGAN and latent
statistics of a tiny LBBDM, sampled at 64^2: AlexNet needs that much) and an
LDM-layout VQGAN, converting, sampling and scoring LPIPS with random weights
from ``tools.random_lpips``; FID's wiring is checked with a recorder (one
scipy ``sqrtm`` of a 2048^2 matrix takes ~19 s of CPU here;
``tests/test_torch_eval_metrics.py`` holds ``calc_FID`` itself).
torch runs on one thread.
"""

import ast
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from test_latent import lbbdm_config
from test_torch_checkpoints import write_reference_pth
from test_torch_import import _vqgan_torch_keys
from test_torch_latent_configs import jax_kernel_calls, under_cuda_rule
from test_torch_parallel import one_thread

import chip_smoke
from bbdm_tpu.config import load_config as jax_load

from bbdm_tpu_torch.checkpoints.from_jax import jax_tree_from_state_dict
from bbdm_tpu_torch.checkpoints.io import load_checkpoint
from bbdm_tpu_torch.config import dict2namespace, load_config, save_config
from bbdm_tpu_torch.models import build_model as port_build
from bbdm_tpu_torch.tools import (
    chain_demo,
    pixel_demo,
    random_lpips,
    run_parity,
    stochastic_demo,
)
from bbdm_tpu_torch.tools.synthetic import write_stage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = os.path.join(REPO, "configs", "runs")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_thread():
        yield


def script_report_keys(script):
    """The key sets of the reports a script of ``scripts/`` writes, in the order
    of its ``write_report(result, phase, payload)`` calls: the payload's dict
    literal, a name bound to one, and ``**x`` where ``x = f(...)`` for a
    function ``f`` of the script returning a dict literal."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", script)).read())
    assigned = {n.targets[0].id: n.value for n in ast.walk(tree)
                if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)}
    returned = {f.name: r.value for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
                for r in ast.walk(f) if isinstance(r, ast.Return)
                and isinstance(r.value, ast.Dict)}

    def keys(node):
        if isinstance(node, ast.Name):
            node = assigned[node.id]
        if isinstance(node, ast.Call):
            return keys(returned[node.func.id])
        out = set()
        for k, v in zip(node.keys, node.values):
            out |= keys(v) if k is None else {k.value}
        return out

    calls = [c for c in ast.walk(tree) if isinstance(c, ast.Call)
             and getattr(c.func, "id", None) == "write_report"]
    return [keys(c.args[2]) for c in sorted(calls, key=lambda c: c.lineno)]


def reports(result):
    return {f[len("report_"):-len(".json")]: json.load(open(os.path.join(result, f)))
            for f in sorted(os.listdir(result)) if f.startswith("report_")}


def no_runner(*a, **kw):
    raise AssertionError("a phase with a report built a runner")


def stop_at_first_step(monkeypatch, result, dataset, model):
    """The stop file of the runner's graceful stop, made before the run."""
    d = os.path.join(result, dataset, model)
    os.makedirs(d, exist_ok=True)
    open(os.path.join(d, "STOP"), "w").close()
    return os.path.join(d, "checkpoint", "last_model.ckpt")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """``datasets/`` as the smoke configs name it: a restore tree at 64^2 (8
    train, 4 val, 4 test pairs; the pixel config resizes it to 32^2) and a
    stochastic tree at 32^2 with its ``B_modes``."""
    root = tmp_path_factory.mktemp("demos")
    for name, size, task in (("syn64_smoke", 64, "restore"),
                             ("synstoch_smoke", 32, "stochastic")):
        for stage, n, seed in (("train", 8, 0), ("val", 4, 1_000_000), ("test", 4, 2_000_000)):
            write_stage(str(root / "datasets" / name), stage, n, size, seed, task=task,
                        blur_sigma=0.5)
    return root


# --------------------------------------------------------------- pixel demo

def test_pixel_demo_reports_resume_stop_and_deadline(workdir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(workdir)
    result = str(tmp_path / "pixel")
    argv = ["--result", result, "--config", os.path.join(RUNS, "BBDM-smoke-cpu.yaml"),
            "--epochs", "1", "--variants", "euler:3,heun:3", "--cpu"]
    assert pixel_demo.main(argv + ["--deadline-ts", "1"]) == []
    assert not os.path.exists(result)
    ckpt = stop_at_first_step(monkeypatch, result, "syn64_smoke", "BBDM-pixel-smoke")
    assert pixel_demo.main(argv) == []
    assert os.path.exists(ckpt) and reports(result) == {}
    assert "interrupted (stop file" in capsys.readouterr().out
    assert load_checkpoint(ckpt)["step"] == 1

    rows = pixel_demo.main(argv)
    assert "resuming from" in capsys.readouterr().out
    # the unfinished epoch again from its start: 1 + 8 pairs / batch 4
    assert load_checkpoint(ckpt)["step"] == 3
    train_keys, variant_keys = script_report_keys("train_pixel_demo.py")
    got = reports(result)
    assert sorted(got) == ["eval_euler200", "sweep_euler3", "sweep_heun3", "train"]
    assert set(got["train"]) == train_keys and got["train"]["ckpt"] == ckpt
    assert [(r["sampler"], r["steps"], r["nfe"]) for r in rows] == [
        ("euler", 200, 200), ("euler", 3, 3), ("heun", 3, 5)]
    for r in rows:
        assert set(r) == variant_keys
        for key in ("sample_vs_gt", "condition_vs_gt_floor"):
            assert r[key]["count"] == 4 and 0 < r[key]["psnr"] < 100
    assert rows[0]["eval_root"].endswith(os.path.join("BBDM-pixel-smoke-euler200",
                                                      "sample_to_eval"))

    monkeypatch.setattr("bbdm_tpu_torch.runners.get_runner", no_runner)
    again = pixel_demo.main(argv + ["--variants", "euler:3,heun:3,euler:2",
                                    "--deadline-ts", "1"])
    assert again == json.loads(json.dumps(rows))
    out = capsys.readouterr().out
    assert out.count("report exists, skipping") == 4
    assert "deadline passed, skipping phase sweep_euler2" in out
    assert not os.path.exists(os.path.join(result, "report_sweep_euler2.json"))


# ---------------------------------------------------------- stochastic demo

def test_stochastic_demo_reports_resume_stop_and_deadline(workdir, tmp_path, monkeypatch,
                                                          capsys):
    monkeypatch.chdir(workdir)
    result = str(tmp_path / "stoch")
    argv = ["--result", result, "--config", os.path.join(RUNS, "BBDM-stoch-smoke-cpu.yaml"),
            "--epochs", "1", "--variants", "euler:4,heun:3", "--sample-num", "2", "--cpu"]
    assert stochastic_demo.main(argv + ["--deadline-ts", "1"]) == []
    assert not os.path.exists(result)
    ckpt = stop_at_first_step(monkeypatch, result, "synstoch_smoke", "BBDM-stoch-smoke")
    assert stochastic_demo.main(argv) == []
    assert os.path.exists(ckpt) and reports(result) == {}
    assert "phase T interrupted (stop file" in capsys.readouterr().out

    rows = stochastic_demo.main(argv)
    assert "resuming training from" in capsys.readouterr().out
    train_keys, row_keys = script_report_keys("eval_stochastic_demo.py")
    got = reports(result)
    assert sorted(got) == ["sweep_euler4", "sweep_heun3", "train"]
    assert set(got["train"]) == train_keys and got["train"]["ckpt"] == ckpt
    assert [(r["sampler"], r["steps"], r["nfe"]) for r in rows] == [("euler", 4, 4),
                                                                     ("heun", 3, 5)]
    for r in rows:
        assert set(r) == row_keys
        assert r["images"] == 4 and r["draws_per_image"] == 2
        assert sum(r["mode_histogram"]) == 8 and 1 <= r["mode_coverage_mean"] <= 2
        assert 0 < r["best_mode_psnr_mean"] < 99 and r["diversity"] >= 0
        tree = os.path.join(result, "synstoch_smoke", f"stoch-{r['sampler']}{r['steps']}",
                            "sample_to_eval", str(r["steps"]))
        assert r == got[f"sweep_{r['sampler']}{r['steps']}"]
        assert stochastic_demo.score_mode_tree(
            tree, os.path.join("datasets", "synstoch_smoke", "test", "B_modes"),
            os.path.join(os.path.dirname(tree), "condition"), 2).items() <= r.items()

    monkeypatch.setattr("bbdm_tpu_torch.runners.get_runner", no_runner)
    again = stochastic_demo.main(argv + ["--variants", "euler:4,heun:3,euler:2",
                                         "--deadline-ts", "1"])
    assert again == rows
    out = capsys.readouterr().out
    assert out.count("report exists") == 3 and "skipping sweep_euler2" in out


# --------------------------------------------------------------- chain demo

def test_chain_demo_reports_resume_stop_and_deadline(workdir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(workdir)
    result = str(tmp_path / "chain")
    argv = ["--result", result, "--vqgan-config", os.path.join(RUNS, "VQGAN-smoke-cpu.yaml"),
            "--lbbdm-config", os.path.join(RUNS, "LBBDM-smoke-cpu.yaml"),
            "--epochs-a", "1", "--epochs-b", "1", "--bench-sampler", "euler",
            "--bench-sample-step", "3", "--bench-images", "4", "--cpu"]
    vq_ckpt = stop_at_first_step(monkeypatch, result, "syn64_smoke", "VQGAN-smoke")
    assert chain_demo.main(argv) == {}
    assert os.path.exists(vq_ckpt) and reports(result) == {}
    assert "phase A interrupted (stop file" in capsys.readouterr().out

    # phase A resumes and finishes; phase B is past the deadline
    assert set(chain_demo.main(argv + ["--deadline-ts", "1"])) == {"vqgan"}
    out = capsys.readouterr().out
    assert "resuming training from" in out and "deadline passed, skipping phase B" in out
    assert int(load_checkpoint(vq_ckpt)["epoch"]) == 1

    got = chain_demo.main(argv)
    assert "phase A report exists" in capsys.readouterr().out
    keys = dict(zip(("vqgan", "bridge", "eval", "throughput"),
                    script_report_keys("train_chain_demo.py")))
    assert got == reports(result) and sorted(got) == sorted(keys)
    for phase, report in got.items():
        assert set(report) == keys[phase], phase
    assert got["vqgan"]["ckpt"] == vq_ckpt == got["bridge"]["vq_ckpt"]
    assert int(load_checkpoint(got["bridge"]["ckpt"])["epoch"]) == 1
    for key in ("sample_vs_gt", "condition_vs_gt_floor", "vqgan_roundtrip_ceiling"):
        assert got["eval"][key]["count"] == 4 and 0 < got["eval"][key]["psnr"] < 100, key
    tput = got["throughput"]
    assert (tput["sample_num"], tput["sampler"], tput["sample_step"]) == (5, "euler", 3)
    assert (tput["images"], tput["samples"]) == (4, 20) and tput["delivered_samples_per_sec"] > 0
    tree = os.path.join(result, "syn64_smoke", "LBBDM-f4-chain-tput", "sample_to_eval", "3")
    assert len(os.listdir(tree)) == 4
    assert len(os.listdir(os.path.join(tree, os.listdir(tree)[0]))) == 5

    monkeypatch.setattr("bbdm_tpu_torch.runners.get_runner", no_runner)
    assert chain_demo.main(argv) == got
    out = capsys.readouterr().out
    assert out.count("report exists") == 4, out


def test_chain_demo_throughput_only_runs_phase_d_alone(workdir, tmp_path, monkeypatch):
    monkeypatch.chdir(workdir)
    result = str(tmp_path / "tput")
    got = chain_demo.main([
        "--result", result, "--lbbdm-config", os.path.join(RUNS, "LBBDM-smoke-cpu.yaml"),
        "--throughput-only", "--bench-sample-num", "2", "--bench-images", "4",
        "--bench-sample-step", "3", "--cpu"])
    assert sorted(got) == ["throughput"] and got["throughput"]["samples"] == 8
    assert got["throughput"]["sampler"] == "euler"  # the config names none: the default


def test_demos_raise_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (pixel_demo, stochastic_demo, chain_demo):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tool.main(["--result", str(tmp_path / "r")])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_parity.main(["--vqgan", "x", "--out", str(tmp_path / "p")])
    assert not os.listdir(tmp_path)


# --------------------------------------------------------------- run_parity

def test_run_parity_converts_samples_and_scores(tmp_path, monkeypatch, capsys):
    cfg = lbbdm_config()
    tree = jax_tree_from_state_dict(port_build(cfg, device="cpu"))
    write_reference_pth(str(tmp_path / "ref.pth"), cfg, tree, tree, seed=5)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in _vqgan_torch_keys(
        32, (1, 2), 1, 3, 3, 32, 16).items() if not k.startswith("loss.")}},
        str(tmp_path / "ldm.ckpt"))
    full = {"runner": "BBDMRunner", "training": {"n_epochs": 1, "n_steps": 10},
            "testing": {"clip_denoised": False, "sample_num": 1},
            "data": {"dataset_name": "x", "dataset_type": "custom_aligned",
                     "dataset_config": {"dataset_path": "x", "image_size": 64, "channels": 3,
                                        "to_normal": True, "flip": False},
                     "train": {"batch_size": 2}, "val": {"batch_size": 2},
                     "test": {"batch_size": 8}},
            "model": dict(cfg.to_dict(), normalize_latent=True)}
    save_config(dict2namespace(full), str(tmp_path / "cfg.yaml"))
    lpips_w = random_lpips.main(["--out", str(tmp_path / "lpips.pth"), "--cpu"])
    calls = []

    def fid(a, b, *, weights_path, device):
        calls.append((a, b, weights_path, device))
        return 1.5

    monkeypatch.setattr("bbdm_tpu_torch.evaluation.calc_FID", fid)
    out = str(tmp_path / "out")
    argv = ["--vqgan", str(tmp_path / "ldm.ckpt"), "--bbdm", str(tmp_path / "ref.pth"),
            "--config", str(tmp_path / "cfg.yaml"), "--out", out, "--n", "4",
            "--fid-weights", str(tmp_path / "lpips.pth"), "--lpips-weights", lpips_w, "--cpu"]
    got = run_parity.main(argv)
    printed = capsys.readouterr().out
    assert set(got) == {"FID/port", "LPIPS/port"} and got["FID/port"] == 1.5
    assert 0 < got["LPIPS/port"] < 10
    for line in ("pytorch_fid not installed", "lpips not installed", "(step=11, epoch=2)",
                 "=== parity report ==="):
        assert line in printed, line
    converted = load_checkpoint(os.path.join(out, "converted_model.ckpt"))
    assert sorted(converted["model"]) == ["unet", "vqgan"] and "ori_latent_mean" in converted
    root = os.path.join(out, "parity", "tiny-lbbdm", "sample_to_eval")
    names = sorted(os.listdir(os.path.join(root, "ground_truth")))
    assert names == [f"test_{i:05d}.png" for i in range(4)]
    assert sorted(os.listdir(os.path.join(root, "4"))) == names
    assert calls == [(os.path.join(root, "4"), os.path.join(root, "ground_truth"),
                      str(tmp_path / "lpips.pth"), torch.device("cpu"))]

    # two draws: the metrics take the first draws, flattened by name
    calls.clear()
    got = run_parity.main(argv + ["--sample-num", "2", "--out", str(tmp_path / "two")])
    flat = os.path.join(str(tmp_path / "two"), "samples_flat")
    assert sorted(os.listdir(flat)) == names and calls[0][0] == flat
    assert np.isfinite(got["LPIPS/port"])
    with pytest.raises(SystemExit, match="not found"):
        run_parity.main(["--vqgan", str(tmp_path / "none.ckpt"), "--out", out, "--cpu",
                         "--config", str(tmp_path / "cfg.yaml")])
    assert load_config(str(tmp_path / "cfg.yaml")).data.test.batch_size == 8


# ------------------------------------------- phase 14's launch counts

@pytest.mark.parametrize("name", ["LBBDM-f4-syn256-v2", "BBDM-synpix64"])
def test_demo_launch_counts_come_from_the_jax_modules_calls(name):
    cfg = jax_load(os.path.join(RUNS, f"{name}.yaml"))
    pixel = cfg.model.model_type == "BBDM"
    want = {part: under_cuda_rule(c) for part, c in jax_kernel_calls(cfg, 8).items()}
    got = chip_smoke.kernel_calls(chip_smoke.demo_configs()[name].model, 8)
    assert got["unet"] == want["unet"] and sum(got["unet"].values()) > 0
    assert got["unet_train"] == Counter({k: n for k, n in want["unet"].items() if k[0] != "K2"})
    assert got["encoder"] + got["decoder"] == want["vqgan"]
    if pixel:
        assert got["encoder"] == got["decoder"] == Counter()
