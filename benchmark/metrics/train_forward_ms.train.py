"""Milliseconds of host time per microbatch's loss, the two frozen VQGAN
encodes included: the median of the program's ``train.forward`` spans
(``training/step.py``), the profiled microbatches left out."""

from benchmark.program_spans import median_ms


def read(obs):
    return median_ms(obs, "train.forward")
