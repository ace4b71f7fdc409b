"""Milliseconds of host time per reverse step: the median of the program's
``sampler.step`` spans (``models/bridge.py``) in the window, the profiled
batch left out. No step syncs, so in a device-bound cell the host's step
lasts as long as the launch queue makes it wait."""

from benchmark.program_spans import median_ms


def read(obs):
    return median_ms(obs, "sampler.step")
