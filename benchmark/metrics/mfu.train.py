"""The whole step's share of the card's dense bf16 peak: the FLOPs of the work
the window completed (``benchmark/flops.py``) over the window, over 989 TFLOP/s,
with the profiled part of the window (its time and its work) left out."""

from benchmark.roofline import PEAK_BF16_FLOPS


def read(obs):
    return 100.0 * obs["untraced_flops"] / obs["untraced_s"] / PEAK_BF16_FLOPS
