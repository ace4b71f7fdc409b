"""Operators with a hand-written Hopper kernel and a plain PyTorch twin.

Each dispatch sends a CUDA tensor to the kernel and a CPU tensor to the twin;
the twin is never a fallback for a CUDA tensor.
"""

import torch

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense bf16 tensor-core and fp32 rates;
# the kernels' bounds divide their bytes and operations by these
PEAK_BYTES_S, PEAK_BF16_FLOPS, PEAK_FP32_FLOPS = 3.35e12, 989e12, 67e12


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises on any other device."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel and no twin for device {x.device}")
