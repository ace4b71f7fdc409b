"""The share of reverse steps that replayed a captured CUDA graph, in %: the
program's ``sampler.replay`` spans over its ``sampler.step`` spans
(``models/bridge.py``) in the window, the profiled batch left out. A program
that replays no step (one without the graph, or a run off the card) leaves
the metric out."""

from benchmark.program_spans import durations_s


def read(obs):
    replays, steps = durations_s(obs, "sampler.replay"), durations_s(obs, "sampler.step")
    if not replays or not steps:
        return None
    return 100.0 * len(replays) / len(steps)
