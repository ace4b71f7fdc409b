"""Milliseconds per reverse step outside the UNet: the median of each
``sampler.step`` span's time less its ``unet.forward`` children (the
parameter swap of ``functional_call``, the bridge update, the host
conversions), the profiled batch left out."""

from benchmark.program_spans import median_ms


def read(obs):
    return median_ms(obs, "sampler.step", less_children="unet.forward")
