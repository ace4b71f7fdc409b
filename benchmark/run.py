"""Run one cell of ``BENCHMARK.json`` once and print the result as the last
line of standard output:

    python3 benchmark/run.py --workload lbbdm_f4.sample.b32n1 --seed 7 --seconds 30 --trace 0

Set-up (``setup_s``) runs from this script's first statement to the window's
start: imports, the kernel library's load, the runner and its weights from
the seed, and the warm-up of the cell's shapes. The window then drives the
program for ``--seconds`` (no new batch or update starts after them) and
closes when the work in flight has finished. After it, the program's state
is freed and the plain reference judges what the window produced
(``correct``). ``--trace 1`` adds the benchmark's spans and a profiler over
the slice the traffic file names, and reports the per-layer metrics.

The run needs a CUDA card; it exits with 2 and prints no result where there
is none (or fewer than the cell asks for), and with 3 where the process
loaded JAX or the JAX package. Caches go under ``.bench_cache/`` in the
checkout; scratch files (the PNGs) under ``TMPDIR``, deleted at exit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
sys.path.insert(0, ROOT)


def run(cell, seed: int, seconds: float, trace: int, device, card=None, t_start=T_START):
    """One run of ``cell`` on ``device``: (result line, checks). ``card`` (a
    ``harness.Card``) samples the clocks over the window where given."""
    from benchmark import harness

    scratch = tempfile.mkdtemp(prefix="bench-", dir=os.environ.get("TMPDIR"))
    try:
        ctx = dict(config=cell.config, traffic=cell.traffic, seed=seed, seconds=seconds,
                   trace=trace, device=device, scratch=scratch)
        state = cell.entry.setup(ctx)
        setup_s = time.perf_counter() - t_start
        if card is not None:
            card.start()
        try:
            obs = cell.entry.window(state, ctx)
        finally:
            if card is not None:
                card.stop()
        obs["setup_s"] = setup_s
        t_check = time.perf_counter()
        checks = cell.entry.check(state, obs, ctx, cell.limits)
        print(f"setup {setup_s:.3f} s, window {obs['window_s']:.3f} s, reference and "
              f"comparison {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    device_line = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": card.kind if card is not None else str(device),
                   "count": cell.workload["chips"], "memory_peak_bytes": obs["peak_bytes"],
                   **(card.detail() if card is not None else {})}
    if trace:
        device_line.update(busy_s=obs["trace"]["busy_s"], window_s=obs["trace"]["window_s"])
    return harness.result_line(cell, obs, checks, device_line, trace), checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.Cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")),
                        args.workload, ROOT)
    import torch

    need = cell.workload["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"needs {need} CUDA card(s), found {have}", file=sys.stderr)
        return 2
    line, checks = run(cell, args.seed, args.seconds, args.trace, torch.device("cuda", 0),
                       harness.Card(0))
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
