"""Operators with a hand-written Hopper kernel and a plain PyTorch twin.

Each dispatch sends a CUDA tensor to the kernel and a CPU tensor to the twin;
the twin is never a fallback for a CUDA tensor.
"""

import torch


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises on any other device."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel and no twin for device {x.device}")
