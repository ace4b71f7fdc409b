"""Spans and the device trace: what the per-layer metrics read.

Spans are the benchmark's own, recorded around its calls into the program's
layers (:class:`Spans`): a name, a start and an end on the host's clock,
kept in memory. Inside the traced slice each span is also a
``torch.profiler.record_function`` named ``bench.<name>``, so that the
device's idle gaps can be labelled with what the host was doing.

:func:`reduce_profile` turns the profiler's events for the slice into the
slice's wall time, the device's busy time (the union of kernel, copy and fill
intervals), each device operation's total time, and the idle gaps totalled
by the innermost benchmark span that holds each gap's midpoint.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

SLICE = "bench.slice"


class Spans:
    """Named host-clock intervals; ``profiled`` adds a profiler annotation.

    The part of the window that the profiler covers, from just before its
    start to just after its stop, is kept apart (:meth:`begin_traced`,
    :meth:`end_traced`), so that a metric read from spans or from the
    window's length can leave the profiler's cost out."""

    def __init__(self):
        self.done = defaultdict(list)  # name -> [(start, end)]
        self.traced = []  # [(start, end)] of the profiled part
        self.profiled = False

    @contextlib.contextmanager
    def __call__(self, name, sync=False):
        ann = (torch.profiler.record_function(f"bench.{name}") if self.profiled
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ann:
            try:
                yield
            finally:
                if sync and torch.cuda.is_available():
                    torch.cuda.synchronize()
        self.done[name].append((t0, time.perf_counter()))

    def begin_traced(self):
        self.profiled = True
        self.traced.append((time.perf_counter(), None))

    def end_traced(self):
        self.profiled = False
        self.traced[-1] = (self.traced[-1][0], time.perf_counter())

    def traced_s(self) -> float:
        return sum(b - a for a, b in self.traced)

    def untraced(self, name) -> list:
        """The spans ``name`` that lie outside the profiled part."""
        return [(a, b) for a, b in self.done[name]
                if not any(a < e and s < b for s, e in self.traced)]

    def total(self, name) -> float:
        return sum(b - a for a, b in self.untraced(name))

    def count(self, name) -> int:
        return len(self.untraced(name))


def _events(prof):
    """(name, device is the card, user annotation, start_us, end_us) of every event."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        t0 = results.trace_start_ns()
        for e in results.events():
            yield (e.name(), e.device_type() == torch.autograd.DeviceType.CUDA,
                   e.is_user_annotation(), (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3)
        return
    for e in prof.events():
        yield (e.name, e.device_type == torch.autograd.DeviceType.CUDA, e.is_user_annotation,
               e.time_range.start, e.time_range.end)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_profile(prof) -> dict:
    """{window_s, busy_s, op_s: {name: s}, gaps_s: {label: s}} of the slice
    that the ``bench.slice`` annotation bounds."""
    device, spans, window = [], [], None
    for name, on_card, annotation, a, b in _events(prof):
        if on_card and not annotation:
            device.append((a, b, name))
        elif not on_card and name == SLICE:
            window = (a, b)
        elif not on_card and name.startswith("bench."):
            spans.append((a, b, name[len("bench."):]))
    if window is None:
        raise RuntimeError("the trace holds no bench.slice annotation")
    lo, hi = window
    device = [(max(a, lo), min(b, hi), n) for a, b, n in device if b > lo and a < hi]
    op_s = defaultdict(float)
    for a, b, n in device:
        op_s[n] += (b - a) / 1e6
    busy = _union((a, b) for a, b, _ in device)
    gaps, prev = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps_s = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        holding = [(e - s, n) for s, e, n in spans if s <= mid <= e]
        gaps_s[min(holding)[1] if holding else "runner (outside the benchmark's spans)"] += (b - a) / 1e6
    return {"window_s": (hi - lo) / 1e6, "busy_s": sum(b - a for a, b in busy) / 1e6,
            "op_s": dict(op_s), "gaps_s": dict(gaps_s)}


def kernel_s(reduced: dict, patterns) -> float:
    """Device seconds of the operations whose names contain one of ``patterns``."""
    return sum(s for n, s in reduced["op_s"].items() if any(p in n for p in patterns))


def breakdown(reduced: dict, top: int = 10) -> dict:
    """The contract's ``breakdown``: the device operations that took most time
    and the idle time by what the host was doing, each as [name, seconds]."""
    def largest(d):
        return [[n, s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": largest(reduced["op_s"]), "idle_gaps": largest(reduced["gaps_s"])}
