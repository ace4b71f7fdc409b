"""The program's span recorder (``bbdm_tpu_torch/utils/spans.py``), the spans
placed in the sampler, the UNet, ``sample_to_eval`` and the train step, and
the benchmark's per-layer metrics that read them (``benchmark/program_spans.py``).

CPU cases: the recorder's nesting, threads, ring and profiler annotations;
the spans of a tiny LBBDM (the benchmark tests' configuration) through
``sample_to_eval`` (euler and heun), the train step and a
``training.profile_dir`` trace; each metric file against hand-built records;
a ``--trace 1`` run of a sample cell and the train cell at that size.

GPU case (marker ``gpu``, skipped without a card): an LBBDM-f16-shaped
``p_sample_loop`` under ``torch.profiler``, for the shared clock, the share
of the card's idle time the steps cover, and that no span synchronises. No
jax is imported, so on a machine without jax it runs with
``python -m pytest tests/test_torch_spans.py -m gpu --noconftest``.
"""

import copy
import gc
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from bbdm_tpu_torch.utils import spans
from bbdm_tpu_torch.utils.spans import Record, span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

TINY = harness.load_module(os.path.join(ROOT, "benchmark", "tests", "conftest.py"),
                           "bench_tests_conftest").TINY
NEW_METRICS = {"sample": ["sampler_host_ms.sample", "sampler_step_self_ms.sample",
                          "writer_wait.sample"],
               "train": ["train_forward_ms.train", "train_backward_ms.train",
                         "train_update_ms.train"]}


@pytest.fixture(autouse=True)
def fresh():
    """An empty ring and torch on one thread (the suite's workers hold every core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.clear()
    try:
        yield
    finally:
        torch.set_num_threads(n)
        spans.clear()


def by_name(recs, name):
    return [r for r in recs if r.name == name]


def children(recs, parent, name=None):
    return [r for r in recs if r.parent == parent.index and (name is None or r.name == name)]


# ------------------------------------------------------------------ the recorder

def test_nesting_gives_parent_indices():
    with span("a"):
        with span("b"):
            with span("c"):
                pass
        with span("d"):
            pass
    with span("e"):
        pass
    recs = {r.name: r for r in spans.records()}
    assert [r.name for r in spans.records()] == ["c", "b", "d", "a", "e"]
    assert recs["a"].parent is None and recs["e"].parent is None
    assert recs["b"].parent == recs["d"].parent == recs["a"].index
    assert recs["c"].parent == recs["b"].index
    assert all(r.thread == threading.get_ident() for r in recs.values())
    for r in recs.values():
        assert r.start <= r.end
    assert recs["a"].start <= recs["b"].start and recs["d"].end <= recs["a"].end


def test_parent_stack_is_per_thread():
    opened, done = threading.Event(), threading.Event()

    def other():
        opened.wait(10)
        with span("other.root"):
            with span("other.child"):
                pass
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with span("main.root"):
        opened.set()
        assert done.wait(10)
        with span("main.child"):
            pass
    t.join(10)
    assert not t.is_alive()
    recs = {r.name: r for r in spans.records()}
    assert recs["other.root"].parent is None
    assert recs["other.child"].parent == recs["other.root"].index
    assert recs["main.child"].parent == recs["main.root"].index
    assert recs["other.root"].thread == t.ident != recs["main.root"].thread


def test_a_span_that_raises_is_recorded_and_closed():
    with pytest.raises(ValueError):
        with span("outer"):
            with span("inner"):
                raise ValueError("boom")
    with span("after"):
        pass
    recs = {r.name: r for r in spans.records()}
    assert recs["inner"].parent == recs["outer"].index and recs["after"].parent is None


def test_the_ring_keeps_the_newest_capacity_records():
    extra = 10
    for _ in range(spans.CAPACITY + extra):
        with span("x"):
            pass
    recs = spans.records()
    assert len(recs) == spans.CAPACITY
    assert recs[-1].index - recs[0].index == spans.CAPACITY - 1
    spans.clear()
    assert spans.records() == []


def test_annotations_only_while_a_profiler_collects(monkeypatch):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("spans.test.outer"):
            with span("spans.test.inner"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"spans.test.outer", "spans.test.inner"} <= names

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with span("spans.test.bare"):
        pass
    assert spans.records()[-1].name == "spans.test.bare"


# ---------------------------------------------------------- spans in the program

def tiny_runner(sampler="euler"):
    from bbdm_tpu_torch.config import dict2namespace
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    cfg = copy.deepcopy(TINY)
    cfg["model"]["BB"]["params"]["sampler"] = sampler
    return BBDMRunner(dict2namespace(cfg), device=torch.device("cpu"), seed=3), cfg


def tiny_batches(n, cfg):
    rs = np.random.RandomState(0)
    B, size = cfg["data"]["test"]["batch_size"], cfg["data"]["dataset_config"]["image_size"]
    out = []
    for i in range(n):
        names = [f"b{i}_{r}" for r in range(B)]
        out.append({"x": rs.uniform(-1, 1, (B, size, size, 3)).astype(np.float32),
                    "x_cond": rs.uniform(-1, 1, (B, size, size, 3)).astype(np.float32),
                    "x_name": names, "x_cond_name": names})
    return out


@pytest.mark.parametrize("sampler", ["euler", "heun"])
def test_sample_to_eval_records_loops_steps_and_unet_forwards(tmp_path, sampler):
    runner, cfg = tiny_runner(sampler)
    batches, draws = 3, cfg["testing"]["sample_num"]
    spans.clear()
    runner.sample_to_eval(tiny_batches(batches, cfg), str(tmp_path))
    recs = spans.records()
    loops = by_name(recs, "sampler.loop")
    assert len(loops) == batches * draws and all(r.parent is None for r in loops)
    grid = len(runner.model.coeffs.steps)
    for loop in loops:
        steps = children(recs, loop, "sampler.step")
        assert len(steps) == grid
        assert len(children(recs, loop)) == grid  # nothing else directly below the loop
        per_step = [len(children(recs, s, "unet.forward")) for s in steps]
        assert per_step == ([1] * grid if sampler == "euler" else [2] * (grid - 1) + [1])
    forwards = by_name(recs, "unet.forward")
    assert len(forwards) == sum(len(children(recs, s)) for s in by_name(recs, "sampler.step"))
    waits = by_name(recs, "runner.writer_wait")
    # one before each batch's hand-off to the writer, one around the final drain
    assert len(waits) == batches + 1 and all(r.parent is None for r in waits)


def test_train_step_records_forward_backward_and_updates_on_update_microbatches():
    runner, cfg = tiny_runner()
    acc = cfg["training"]["accumulate_grad_batches"]
    runner.state = runner.build_initial_state()
    step = runner.build_train_step()
    runner.model.train()
    g = torch.Generator().manual_seed(0)
    spans.clear()
    n = 3 * acc
    for _ in range(n):
        x, y = (torch.rand(4, 3, 32, 32, generator=g) * 2 - 1 for _ in range(2))
        step(runner.state, x, y, generator=g)
    recs = spans.records()
    steps = sorted(by_name(recs, "train.step"), key=lambda r: r.index)
    assert len(steps) == n and all(r.parent is None for r in steps)
    for i, s in enumerate(steps, start=1):
        names = [r.name for r in sorted(children(recs, s), key=lambda r: r.index)]
        want = ["train.forward", "train.backward"] + (["train.update"] if i % acc == 0 else [])
        assert names == want, (i, names)
        fwd = children(recs, s, "train.forward")[0]
        assert len(children(recs, fwd, "unet.forward")) == 1
    assert len(by_name(recs, "unet.forward")) == n  # none in the backward or the update


def test_profile_dir_trace_holds_the_train_spans(tmp_path):
    from bbdm_tpu_torch.config import dict2namespace
    from bbdm_tpu_torch.runners.base import _ProfileWindow

    runner, cfg = tiny_runner()
    runner.state = runner.build_initial_state()
    step = runner.build_train_step()
    runner.model.train()
    window = _ProfileWindow(dict2namespace({"profile_dir": str(tmp_path), "profile_start_step": 1,
                                            "profile_steps": 2}), torch.device("cpu"))
    g = torch.Generator().manual_seed(1)
    logs = []
    for global_step in range(1, 3):
        window.step(global_step, logs.append)
        x, y = (torch.rand(4, 3, 32, 32, generator=g) * 2 - 1 for _ in range(2))
        step(runner.state, x, y, generator=g)
    window.step(3, logs.append)
    assert os.listdir(tmp_path) == ["steps_2-3.pt.trace.json"] and logs
    with open(tmp_path / "steps_2-3.pt.trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"train.step", "train.forward", "train.backward", "train.update",
            "unet.forward"} <= names


# ------------------------------------------------------------- the metric files

def metric(name):
    return harness.load_module(os.path.join(ROOT, "benchmark", "metrics", f"{name}.py"),
                               "spans_test_" + name.replace(".", "_"))


def hand_obs(monkeypatch, recs, window=(10.0, 20.0), traced=(14.0, 16.0)):
    """An ``obs`` whose benchmark spans open at ``window[0]`` with ``traced``
    profiled, and whose program holds ``recs`` (name, start s, end s, parent)."""
    from benchmark.trace import Spans

    done = Spans()
    done.done["sample_batch"] = [window]
    done.traced = [traced]
    ring = [Record(i, n, int(a * 1e9), int(b * 1e9), p, 1) for i, (n, a, b, p) in enumerate(recs)]
    monkeypatch.setattr(spans, "records", lambda: list(ring))
    return {"spans": done, "untraced_s": window[1] - window[0] - (traced[1] - traced[0])}


SAMPLE_RECS = [
    ("sampler.step", 5.0, 5.9, None),  # 0: set-up and warm-up, before the window
    ("unet.forward", 5.1, 5.2, 0),
    ("sampler.step", 11.0, 11.010, None),  # 2: 10 ms, a 7 ms forward
    ("unet.forward", 11.001, 11.008, 2),
    ("sampler.step", 12.0, 12.020, None),  # 4: 20 ms, two forwards of 6 ms (heun)
    ("unet.forward", 12.002, 12.008, 4),
    ("unet.forward", 12.010, 12.016, 4),
    ("sampler.step", 13.0, 13.012, None),  # 7: 12 ms, a 9 ms forward
    ("unet.forward", 13.001, 13.010, 7),
    ("sampler.step", 13.99, 14.5, None),  # 9: overlaps the profiled part
    ("unet.forward", 14.1, 14.2, 9),
    ("runner.writer_wait", 9.0, 9.5, None),  # before the window
    ("runner.writer_wait", 12.5, 12.6, None),
    ("runner.writer_wait", 15.0, 15.5, None),  # profiled
    ("runner.writer_wait", 19.0, 19.2, None),
]
TRAIN_RECS = [
    ("train.forward", 9.0, 9.5, None),  # set-up
    ("train.backward", 9.5, 9.9, None),
    ("train.update", 9.9, 9.95, None),
    ("train.forward", 10.5, 10.530, None),
    ("train.backward", 10.530, 10.600, None),
    ("train.forward", 11.0, 11.040, None),
    ("train.backward", 11.040, 11.120, None),
    ("train.update", 11.120, 11.130, None),
    ("train.forward", 12.0, 12.050, None),
    ("train.backward", 12.050, 12.140, None),
    ("train.update", 12.140, 12.170, None),
    ("train.forward", 15.0, 15.5, None),  # profiled
    ("train.backward", 15.5, 15.9, None),
    ("train.update", 15.9, 15.99, None),
]


@pytest.mark.parametrize("name,recs,want", [
    ("sampler_host_ms.sample", SAMPLE_RECS, 12.0),  # median of 10, 20, 12
    ("sampler_step_self_ms.sample", SAMPLE_RECS, 3.0),  # median of 3, 8, 3
    ("writer_wait.sample", SAMPLE_RECS, 100.0 * 0.3 / 8.0),
    ("train_forward_ms.train", TRAIN_RECS, 40.0),
    ("train_backward_ms.train", TRAIN_RECS, 80.0),
    ("train_update_ms.train", TRAIN_RECS, 20.0),  # the mean of 10 and 30
])
def test_metric_reads_the_window_outside_the_profiled_part(monkeypatch, name, recs, want):
    got = metric(name).read(hand_obs(monkeypatch, recs))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", NEW_METRICS["sample"] + NEW_METRICS["train"])
def test_metric_is_silent_without_the_recorder_or_its_spans(monkeypatch, name):
    obs = hand_obs(monkeypatch, [("other", 11.0, 11.1, None)])
    assert metric(name).read(obs) is None
    import bbdm_tpu_torch.utils

    monkeypatch.delattr(bbdm_tpu_torch.utils, "spans")  # an older program: no recorder
    monkeypatch.setitem(sys.modules, "bbdm_tpu_torch.utils.spans", None)
    assert metric(name).read(obs) is None


@pytest.mark.parametrize("cell_name,kind", [("lbbdm_f4.sample.b32n1", "sample"),
                                            ("lbbdm_f4.train.b8a4", "train")])
def test_traced_run_reports_the_new_metrics(cell_name, kind):
    from benchmark import run

    cell = harness.Cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), cell_name, ROOT)
    cell.config = copy.deepcopy(TINY)
    cell.traffic = dict(cell.traffic, batch=4, pool=16, sample_num=1, trace_batch=1,
                        trace_start=2, trace_microbatches=2, check_update_from=1,
                        check_update_span=1)
    line, _ = run.run(cell, 2 ** 31 + 5, 1.0, 1, torch.device("cpu"),
                      t_start=time.perf_counter())
    assert line["correct"] is True, line["checks"]
    for name in NEW_METRICS[kind]:
        value = line["metrics"][name]["value"]
        assert np.isfinite(value) and value >= 0, (name, value)
    host, self_ms = (line["metrics"].get(k, {}).get("value")
                     for k in ("sampler_host_ms.sample", "sampler_step_self_ms.sample"))
    if kind == "sample":
        assert 0 < self_ms < host


# ------------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


def _kineto(prof):
    """[(name, on the card, start ns, end ns)] of the profile's events, the
    card's copies of the annotations left out."""
    out = []
    for e in prof.profiler.kineto_results.events():
        on_card = e.device_type() == torch.autograd.DeviceType.CUDA
        if not (on_card and e.is_user_annotation()):
            out.append((e.name(), on_card, e.start_ns(), e.end_ns()))
    return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap(a, b, intervals):
    return sum(max(0, min(b, e) - max(a, s)) for s, e in intervals)


@pytest.mark.gpu
def test_spans_share_the_profilers_clock_and_never_sync(cuda):
    """An LBBDM-f16-shaped loop (the benchmark's configuration, batch 8, a
    16^2 x 8 latent, 200 euler steps) under ``torch.profiler``: each step's
    annotation starts a constant offset from its record (the two clocks are
    one), the steps hold the card's idle time inside the loop, and the loop
    runs under ``set_sync_debug_mode("error")``. On the card nine in ten
    offsets lie within 12 us of their median; a single step of a run may land
    65-106 us off, when the shared host stalls between the two reads."""
    from bbdm_tpu_torch.config import dict2namespace
    from bbdm_tpu_torch.models import build_model

    with open(os.path.join(ROOT, "benchmark", "configs", "lbbdm_f16.json")) as f:
        cfg = dict2namespace(json.load(f))
    model = build_model(cfg.model, device=cuda)
    g = torch.Generator(cuda).manual_seed(0)
    y = torch.randn((8, 8, 16, 16), generator=g, device=cuda)
    noise = [torch.randn(y.shape, generator=g, device=cuda) for _ in range(model.noised_steps())]
    model.p_sample_loop(y, noise=noise, clip_denoised=False)  # kernels built, plans made
    torch.cuda.synchronize()
    spans.clear()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    gc.disable()  # a collection between a record's clock read and its annotation's
    try:
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                model.p_sample_loop(y, noise=noise, clip_denoised=False)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    finally:
        gc.enable()
    recs = sorted(by_name(spans.records(), "sampler.step"), key=lambda r: r.start)
    events = _kineto(prof)
    ann = sorted((a, b) for n, on_card, a, b in events if n == "sampler.step" and not on_card)
    assert len(recs) == len(ann) == len(model.coeffs.steps)
    offsets = np.array([a - r.start for (a, _), r in zip(ann, recs)], dtype=np.float64)
    dev_us = (offsets - np.median(offsets)) / 1e3
    t_s = np.array([r.start - recs[0].start for r in recs], dtype=np.float64) / 1e9
    drift = np.polyfit(t_s, dev_us, 1)[0]
    print(f"annotation - record start, less its median, us: quantiles "
          f"{np.percentile(dev_us, [0, 5, 50, 95, 100]).round(2).tolist()}, over 50: "
          f"{int((np.abs(dev_us) > 50).sum())} of {len(dev_us)}, worst at steps "
          f"{np.argsort(-np.abs(dev_us))[:5].tolist()}, drift {drift:.3f} us/s")

    (lo, hi), = [(a, b) for n, on_card, a, b in events if n == "sampler.loop" and not on_card]
    busy = _union((max(a, lo), min(b, hi)) for n, on_card, a, b in events
                  if on_card and b > lo and a < hi)
    gaps, prev = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle = sum(b - a for a, b in gaps)
    held = sum(_overlap(a, b, _union(ann)) for a, b in gaps)
    print(f"idle in the loop {idle / 1e6:.3f} ms of {(hi - lo) / 1e6:.3f}; "
          f"in a step {100 * held / idle:.2f}%")
    # one clock: no drift over the loop, and the offset constant to within 50 us
    # but for a step in a hundred that finds the host stalled between the reads
    assert abs(drift) * t_s[-1] <= 50.0
    assert (np.abs(dev_us) <= 50.0).mean() >= 0.99
    assert held >= 0.9 * idle
