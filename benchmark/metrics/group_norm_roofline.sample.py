"""The group_norm kernel's share of its roofline in the traced slice: the least
time its calls could take (``benchmark/roofline.py``, from the reference's
walk) over the device time of the kernels whose names hold one of PATTERNS."""

from benchmark.roofline import roofline_share

PATTERNS = ('group_norm_kernel',)


def read(obs):
    return roofline_share(obs["trace"], "group_norm", PATTERNS)
