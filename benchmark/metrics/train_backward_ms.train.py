"""Milliseconds of host time per microbatch's backward, K1's twin recompute
included: the median of the program's ``train.backward`` spans
(``training/step.py``), the profiled microbatches left out."""

from benchmark.program_spans import median_ms


def read(obs):
    return median_ms(obs, "train.backward")
