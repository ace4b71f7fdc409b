"""The upsample_conv kernel's share of its roofline in the traced slice: the least
time its calls could take (``benchmark/roofline.py``, from the reference's
walk) over the device time of the kernels whose names hold one of PATTERNS."""

from benchmark.roofline import roofline_share

PATTERNS = ('subpixel_upconv_kernel',)


def read(obs):
    return roofline_share(obs["trace"], "upsample_conv", PATTERNS)
