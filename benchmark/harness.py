"""What every cell shares: finding the cell's files by name, the card, the
result line, and the check that the run loaded nothing of JAX.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: it names a
configuration (``configs/<file>``), a traffic mix
(``traffic/<traffic>.json``, whose ``entry`` names
``entries/<entry>.py``) and has its limits in ``limits/<cell>.json``. Each
metric is ``metrics/<name>.py`` with ``read(obs)``; a cell reports the
end-to-end metrics that list it (or list no cells) and the per-layer metrics
that list it (or that move an end-to-end metric it reports). So a later cell,
configuration, traffic mix, entry or metric is added as files and entries of
``BENCHMARK.json``, with no file edited.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "bbdm_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``bench`` (the parsed ``BENCHMARK.json``), its files
    under ``root`` (the directory that holds ``benchmark/``)."""

    def __init__(self, bench: dict, name: str, root: str):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise SystemExit(f"unknown workload {name!r}; known: {sorted(by_name)}")
        self.name, self.workload, self.root = name, by_name[name], root
        conf = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = load_json(os.path.join(root, conf["file"]))
        bdir = os.path.join(root, "benchmark")
        self.traffic = load_json(os.path.join(bdir, "traffic", f"{self.workload['traffic']}.json"))
        self.limits = load_json(os.path.join(bdir, "limits", f"{name}.json"))
        self.entry = load_module(os.path.join(bdir, "entries", f"{self.traffic['entry']}.py"),
                                 f"bench_entry_{self.traffic['entry']}")
        e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        names = {m["name"] for m in e2e}
        layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
        self.metrics = {0: e2e, 1: layer}
        self.bdir = bdir

    def read_metrics(self, obs: dict, trace: int) -> dict:
        out = {}
        for m in self.metrics[trace]:
            mod = load_module(os.path.join(self.bdir, "metrics", f"{m['name']}.py"),
                              "bench_metric_" + m["name"].replace(".", "_"))
            value = mod.read(obs)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out


def _smi(query: str, *extra) -> list:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits",
                          *extra], capture_output=True, text=True, timeout=60)
    return [line.split(", ") for line in out.stdout.strip().splitlines()]


class Card:
    """The card's name and power limit, and its SM clock and power draw
    sampled every 2 s by one ``nvidia-smi`` process over the window."""

    def __init__(self, index: int = 0):
        import torch

        self.index = index
        self.kind = torch.cuda.get_device_name(index)
        self.power_limit_w = float(_smi("power.limit")[index][0])
        self.proc = None
        self.samples = []

    def start(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             f"--id={self.index}", "-lms", "2000"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self):
        if self.proc is None:
            return
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        self.proc = None
        for line in out.strip().splitlines():
            try:
                clock, power = (float(v) for v in line.split(", "))
            except ValueError:
                continue
            self.samples.append((clock, power))

    def detail(self) -> dict:
        clocks = [c for c, _ in self.samples]
        watts = [p for _, p in self.samples]
        return {"power_limit_w": self.power_limit_w,
                "sm_clock_mhz": ([min(clocks), statistics.median(clocks), max(clocks)]
                                 if clocks else None),
                "power_draw_w": ([min(watts), statistics.median(watts), max(watts)]
                                 if watts else None)}


def result_line(cell: Cell, obs: dict, checks: list, device: dict, trace: int) -> dict:
    """The contract's last line; ``checks`` is [(name, value, limit)], each
    passing when value <= limit, and comes last."""
    correct = obs["failed"] == 0 and all(v <= lim for _, v, lim in checks)
    line = {"correct": bool(correct), "attempted": obs["attempted"], "failed": obs["failed"],
            "metrics": cell.read_metrics(obs, trace), "device": device}
    if trace and obs.get("trace") is not None:
        from benchmark.trace import breakdown

        line["breakdown"] = breakdown(obs["trace"])
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return line
