"""The port's two benches on the CPU (``BENCH_DEVICE=cpu``) at the size of
``configs/runs/LBBDM-smoke-cpu.yaml``: ``bench_torch.py`` (sampling) and
``bbdm_tpu_torch.tools.bench_train`` (the train step) each print one JSON line
with ``bench.py``'s keys, their FLOP counts equal the JAX package's, and
without a card and without ``BENCH_DEVICE`` they raise."""

import json
import os
import subprocess
import sys

import pytest
import torch
from test_torch_parallel import one_thread

from bbdm_tpu.config import load_config as jax_load_config
from bbdm_tpu.utils.flops import sampling_flops_per_image, training_flops_per_image
from bbdm_tpu_torch.tools import bench, bench_train

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """torch on one thread for each test: the suite's workers already hold every
    core, and idle OpenMP threads spin (``test_torch_parallel.one_thread``)."""
    with one_thread():
        yield


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "runs", "LBBDM-smoke-cpu.yaml")
KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}  # bench.py:112-123
DETAIL = {"device_kind", "flops_per_sample", "achieved_tflops",
          "ref_est_samples_per_sec_a100_tf32", "batch", "mfu", "peak_memory_bytes"}
TRAIN_DETAIL = {"device_kind", "step_ms", "batch", "flops_per_image", "achieved_tflops",
                "ref_est_images_per_sec_a100_tf32", "mfu", "peak_memory_bytes"}


def json_lines(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


def jax_model_config(**bb):
    cfg = jax_load_config(SMOKE)
    for k, v in bb.items():
        cfg.model.BB.params[k] = v
    return cfg.model


def check_cpu_detail(d, batch):
    assert d["device_kind"] == "cpu" and d["batch"] == batch
    assert d["mfu"] is None and d["peak_memory_bytes"] is None  # no device numbers on the CPU
    assert d["launches"] == {"K1": 0, "K2": 0, "K3": 0}  # the CPU launches no kernel


def test_bench_torch_prints_one_json_line():
    env = dict(os.environ, BENCH_DEVICE="cpu", BENCH_CONFIG=SMOKE, BENCH_STEPS="3",
               BENCH_BATCH="1", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = json_lines(proc.stdout)
    assert len(lines) == 1 and proc.stdout.strip().splitlines()[-1].startswith("{")
    line = lines[0]
    assert set(line) == KEYS and DETAIL <= set(line["detail"])
    assert line["unit"] == "samples/sec/card" and line["value"] > 0
    assert line["metric"] == "LBBDM-smoke 64x64 3-step sampling"
    d = line["detail"]
    check_cpu_detail(d, 1)
    assert d["flops_per_sample"] == sampling_flops_per_image(jax_model_config(sample_step=3))
    assert d["ref_est_samples_per_sec_a100_tf32"] == round(0.35 * 156e12
                                                           / d["flops_per_sample"], 3)
    assert len(d["run_s"]) == 3 and d["kernel_build_s"] is None
    assert torch.isfinite(torch.tensor(d["output_mean"]))


def run_in_process(main, monkeypatch, capsys, **env):
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.setenv("BENCH_CONFIG", SMOKE)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    line = main()
    lines = json_lines(capsys.readouterr().out)
    assert lines == [json.loads(json.dumps(line))]
    return line


def test_bench_heun_counts_its_nfe(monkeypatch, capsys):
    line = run_in_process(bench.main, monkeypatch, capsys, BENCH_STEPS="4",
                          BENCH_SAMPLER="heun", BENCH_BATCH="2")
    assert line["metric"] == "LBBDM-smoke 64x64 4-step sampling (heun)"
    d = line["detail"]
    check_cpu_detail(d, 2)
    assert d["flops_per_sample"] == sampling_flops_per_image(
        jax_model_config(sample_step=4, sampler="heun"))


@pytest.mark.parametrize("accum", [None, "1"])
def test_bench_train_prints_one_json_line(monkeypatch, capsys, accum):
    env = {"BENCH_BATCH": "1"} | ({"BENCH_ACCUM": accum} if accum else {})
    line = run_in_process(bench_train.main, monkeypatch, capsys, **env)
    assert set(line) == KEYS and TRAIN_DETAIL <= set(line["detail"])
    assert line["unit"] == "images/sec/card" and line["value"] > 0
    assert line["metric"] == "LBBDM-smoke 64x64 train step"
    d = line["detail"]
    check_cpu_detail(d, 1)
    assert d["accumulate_grad_batches"] == int(accum or 2)  # the config's 2, or BENCH_ACCUM
    assert d["flops_per_image"] == training_flops_per_image(jax_model_config())
    assert torch.isfinite(torch.tensor(d["loss"]))


@pytest.mark.parametrize("main", [bench.main, bench_train.main], ids=["bench", "bench_train"])
def test_benches_raise_without_a_card(monkeypatch, main):
    """No card and no BENCH_DEVICE: a RuntimeError before any work, never a
    quiet run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    monkeypatch.setenv("BENCH_CONFIG", SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main()
