"""The harness: cells, configurations, traffic, entries and metrics found by
name from files alone; the contract's last line; no JAX in a run's process
and nothing of the program in the reference's."""

import json
import os
import shutil
import subprocess
import sys
import time

import torch

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}


def _tiny_cell(tiny, name="lbbdm_f4.sample.b32n1", **traffic):
    cell = harness.Cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), name, ROOT)
    cell.config = tiny
    cell.traffic = dict(cell.traffic, batch=4, pool=16, trace_batch=0, trace_start=2,
                        trace_microbatches=2, check_update_from=1, check_update_span=1,
                        **traffic)
    return cell


def test_new_cell_config_traffic_and_metric_are_found_from_files(tmp_path, tiny):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(tiny))
    (root / "benchmark" / "traffic" / "sample.b4n2.json").write_text(json.dumps(
        {"entry": "sample_to_eval", "batch": 4, "sample_num": 2, "pool_batches": 2,
         "check_batches": 1, "trace_batch": 0, "trace_draws": 1}))
    (root / "benchmark" / "limits" / "tiny.sample.b4n2.json").write_text(json.dumps(
        {"missing_pngs": 0, "input_png_levels": 0, "latent_rel_err": 1e-3,
         "png_mean_levels": 0.5}))
    (root / "benchmark" / "metrics" / "batches_done.py").write_text(
        "def read(obs):\n    return float(obs['batches'])\n")
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                             "file": "benchmark/configs/tiny.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.sample.b4n2", "config": "tiny",
                               "traffic": "sample.b4n2", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("tiny.sample.b4n2")
    bench["per_layer"].append({"name": "batches_done", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "runner",
                               "moves": "sample_images_per_s", "workloads": ["tiny.sample.b4n2"]})
    cell = harness.Cell(bench, "tiny.sample.b4n2", str(root))
    assert cell.config["model"]["model_name"] == "tiny"
    assert cell.traffic["batch"] == 4 and cell.limits["latent_rel_err"] == 1e-3
    assert cell.entry.__name__.endswith("sample_to_eval")
    assert [m["name"] for m in cell.metrics[0]] == ["sample_images_per_s", "setup_s"]
    assert "batches_done" in [m["name"] for m in cell.metrics[1]]
    from benchmark import run

    line, _ = run.run(cell, 7, 0.5, 0, torch.device("cpu"), t_start=time.perf_counter())
    assert line["correct"] is True
    assert set(line["metrics"]) == {"sample_images_per_s", "setup_s"}
    line, _ = run.run(cell, 7, 0.5, 1, torch.device("cpu"), t_start=time.perf_counter())
    assert line["metrics"]["batches_done"]["value"] >= 1


def _check_line(line, cell, trace):
    assert set(line) <= LINE_KEYS and list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["metrics"]) <= {m["name"] for m in cell.metrics[trace]}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)


def test_last_line_has_the_contracts_keys(tiny):
    from benchmark import run

    for name in ("lbbdm_f4.sample.b32n1", "lbbdm_f4.train.b8a4"):
        cell = _tiny_cell(tiny, name, sample_num=2)
        for trace in (0, 1):
            line, _ = run.run(cell, 2 ** 31 + 11, 1.0, trace, torch.device("cpu"),
                              t_start=time.perf_counter())
            _check_line(line, cell, trace)
            assert line["correct"] is True, line["checks"]


def test_run_loads_no_jax_and_reference_nothing_of_the_program():
    code = """
import sys, time, torch
sys.path.insert(0, %r)
sys.path.insert(0, %r)
import benchmark.reference.model, benchmark.reference.lowp, benchmark.reference.train
import benchmark.roofline, benchmark.flops, benchmark.weights, benchmark.traffic
assert not [n for n in sys.modules if n.split('.')[0] == 'bbdm_tpu_torch'], 'reference'
from conftest import TINY
from benchmark import harness, run
cell = harness.Cell(harness.load_json(%r), 'lbbdm_f4.train.b8a4', %r)
cell.config = TINY
cell.traffic = dict(cell.traffic, batch=2, pool=8, trace_start=2, trace_microbatches=2,
                    check_update_from=0, check_update_span=1)
run.run(cell, 3, 0.5, 0, torch.device('cpu'), t_start=time.perf_counter())
assert 'bbdm_tpu_torch' in sys.modules
print('FORBIDDEN', harness.forbidden_modules())
""" % (ROOT, os.path.join(ROOT, "benchmark", "tests"), os.path.join(ROOT, "BENCHMARK.json"),
       ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={k: v for k, v in os.environ.items()
                                           if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "bbdm_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert not [n for n in harness.forbidden_modules() if n in ("bbdm_tpu_torch_x",
                                                               "jaxtyping_like")]
    monkeypatch.setitem(sys.modules, "bbdm_tpu.models", sys)
    assert "bbdm_tpu.models" in harness.forbidden_modules()


def test_span_metrics_leave_the_profiled_part_out():
    from benchmark.trace import Spans

    spans = Spans()
    spans.done["p_sample_loop"] = [(0.0, 1.0), (2.0, 3.5), (5.0, 6.0)]
    spans.traced = [(1.8, 4.0)]
    assert spans.count("p_sample_loop") == 2 and spans.total("p_sample_loop") == 2.0
    assert abs(spans.traced_s() - 2.2) < 1e-12
