"""Model factory: config.model -> model (port of ``bbdm_tpu/models/factory.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from bbdm_tpu_torch.models.layers import init_parameters


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card, and raises where
    there is none (the CPU only when asked for, ``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def build_model(model_config, *, device=None, dtype=None,
                generator: Optional[torch.Generator] = None):
    """BBDM or LBBDM on ``device`` (default: the CUDA card, see
    :func:`resolve_device`) with seeded random fp32 parameters.

    ``model.mixed_precision`` (default True) selects bf16 compute, else fp32.
    ``generator`` (on ``device``) draws the initial weights; default seed 0.
    """
    from bbdm_tpu_torch.models.bridge import BrownianBridgeModel
    from bbdm_tpu_torch.models.latent import LatentBrownianBridgeModel

    device = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if model_config.get("mixed_precision", True) else torch.float32
    model_type = model_config.model_type
    if model_type == "BBDM":
        model = BrownianBridgeModel(model_config, dtype=dtype, device=device)
    elif model_type == "LBBDM":
        model = LatentBrownianBridgeModel(model_config, dtype=dtype, device=device)
    else:
        raise NotImplementedError(f"model_type {model_type!r}")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init_parameters(model, generator)
    return model.eval()
