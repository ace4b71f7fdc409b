"""The program's own spans (``bbdm_tpu_torch/utils/spans.py``) over a run's
window, read from the recorder in the run's process.

A record counts when it starts at or after the window's first benchmark span
(``obs["spans"].done``, which the entries clear after warm-up, so set-up and
warm-up drop out) and does not overlap the profiled part
(``obs["spans"].traced``), so that the profiler's cost stays out, as it does
for ``runner_wait`` and ``mfu``. Both clocks are ``time.perf_counter``: the
program's in nanoseconds, the benchmark's in seconds.

A program without the recorder, or a window with no such span, gives None
from every reader, and the metric leaves the result line.
"""

from __future__ import annotations

import statistics


def window_records(obs) -> list:
    """The program's records of the window outside the profiled part."""
    try:
        from bbdm_tpu_torch.utils import spans
    except ImportError:
        return []
    done = obs["spans"]
    starts = [a for intervals in done.done.values() for a, _ in intervals]
    if not starts:
        return []
    opened = min(starts)
    kept = []
    for r in spans.records():
        a, b = r.start / 1e9, r.end / 1e9
        if a >= opened and not any(a < e and s < b for s, e in done.traced):
            kept.append(r)
    return kept


def durations_s(obs, name, less_children=None):
    """Seconds of each window span ``name``; with ``less_children``, less
    the time of its direct children of that name (its self time)."""
    recs = window_records(obs)
    out = {r.index: (r.end - r.start) / 1e9 for r in recs if r.name == name}
    if less_children is not None:
        for r in recs:
            if r.name == less_children and r.parent in out:
                out[r.parent] -= (r.end - r.start) / 1e9
    return list(out.values())


def median_ms(obs, name, less_children=None):
    d = durations_s(obs, name, less_children)
    return 1e3 * statistics.median(d) if d else None


def mean_ms(obs, name):
    d = durations_s(obs, name)
    return 1e3 * sum(d) / len(d) if d else None


def share(obs, name):
    """Total seconds of ``name`` over the window outside the profiled part, in %."""
    d = durations_s(obs, name)
    return 100.0 * sum(d) / obs["untraced_s"] if d else None
