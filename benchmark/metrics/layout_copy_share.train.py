"""Share of the device's busy time in the traced slice spent in cuDNN's
NCHW <-> NHWC layout conversions, the kernels whose names hold one of PATTERNS."""

from benchmark.trace import kernel_s

PATTERNS = ("nchwToNhwc", "nhwcToNchw")


def read(obs):
    t = obs["trace"]
    return 100.0 * kernel_s(t, PATTERNS) / t["busy_s"] if t["busy_s"] else None
