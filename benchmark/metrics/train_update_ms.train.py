"""Milliseconds of host time per update (Adam, the plateau, the gradients'
clearing and, every few updates, the EMA): the program's ``train.update``
spans (``training/step.py``) over their number, the profiled microbatches
left out. The mean, not the median, since the EMA runs on some updates only."""

from benchmark.program_spans import mean_ms


def read(obs):
    return mean_ms(obs, "train.update")
