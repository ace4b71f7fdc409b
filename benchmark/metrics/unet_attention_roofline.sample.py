"""The flash_attention kernel's share of its roofline at the cross-attention
UNet's head dims in the traced slice: the least time of the slice's
flash_attention calls with a head dim D <= 256 (which compile to 64, 128 or
256 columns; ``benchmark/roofline.py`` bounds, calls from the entry's walk)
over the device time of the kernels whose names hold one of PATTERNS. The
VQGAN's calls (D = 512) run ``flash_attention_kernel<512>`` and stay out of
both. A program whose kernel takes no such head dim leaves it out."""

from benchmark.roofline import bound_s
from benchmark.trace import kernel_s

PATTERNS = ("flash_attention_kernel<64>", "flash_attention_kernel<128>",
            "flash_attention_kernel<256>")


def read(obs):
    t = obs["trace"]
    spent = kernel_s(t, PATTERNS)
    if not spent:
        return None
    bound = sum(n * bound_s(k, key, t["elsize"]) for (k, key), n in t["calls"].items()
                if k == "flash_attention" and key[3] <= 256)
    return 100.0 * bound / spent
