"""On the card (skipped without one, decided in the fixture): a short run of a
cell, and the control at each cell's own size failing that cell's limits.

    python -m pytest benchmark/tests -m gpu -q
"""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "BENCHMARK.json")


@pytest.mark.gpu
def test_short_cell_runs_correct(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "lbbdm_f16.sample.b8n1", "--seed", str(2 ** 31 + 17), "--seconds", "8",
                          "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert "mfu.sample" in line["metrics"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in harness.load_json(BENCH)["workloads"]])
def test_control_fails_the_cells_limits(card, name):
    from benchmark import control

    cell = harness.Cell(harness.load_json(BENCH), name, ROOT)
    if cell.traffic["entry"] == "train_step":
        readings = control.train_readings(cell, 2 ** 31 + 23, card)["control"]
    else:
        readings = control.sample_readings(cell, 2 ** 31 + 23, card)
    assert any(readings[k] > limit for k, limit in cell.limits.items() if k in readings), readings
