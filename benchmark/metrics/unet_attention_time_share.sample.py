"""Share of the device's busy time in the traced slice spent in the
flash_attention kernel at the cross-attention UNet's head dims (the kernels
whose names hold one of PATTERNS, as ``unet_attention_roofline.sample``
reads them). A program whose kernel takes no such head dim leaves it out."""

from benchmark.trace import kernel_s

PATTERNS = ("flash_attention_kernel<64>", "flash_attention_kernel<128>",
            "flash_attention_kernel<256>")


def read(obs):
    t = obs["trace"]
    spent = kernel_s(t, PATTERNS)
    return 100.0 * spent / t["busy_s"] if spent and t["busy_s"] else None
