"""Model factory: config.model -> model (port of ``bbdm_tpu/models/factory.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from bbdm_tpu_torch.models.layers import init_parameters


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card. A CUDA device
    raises where there is no card (the CPU only when asked for, ``device="cpu"``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' (CLI: --gpu_ids -1) to run on "
                           "the CPU")
    return device


def build_model(model_config, *, device=None, dtype=None,
                generator: Optional[torch.Generator] = None):
    """BBDM, LBBDM or, for VQGAN training, the VQ autoencoder with its
    discriminator (``models/vqgan.VQGANTrainModel``) on ``device`` (default:
    the CUDA card, see :func:`resolve_device`) with seeded random fp32
    parameters.

    ``model.mixed_precision`` selects bf16 compute, else fp32; its default is
    True, and False for ``model_type: VQGAN`` (as the JAX VQGAN runner reads it).
    ``generator`` (on ``device``) draws the initial weights; default seed 0.
    """
    from bbdm_tpu_torch.models.bridge import BrownianBridgeModel
    from bbdm_tpu_torch.models.latent import LatentBrownianBridgeModel
    from bbdm_tpu_torch.models.vqgan import VQGANTrainModel

    device = resolve_device(device)
    model_type = model_config.model_type
    if dtype is None:
        mixed = model_config.get("mixed_precision", model_type != "VQGAN")
        dtype = torch.bfloat16 if mixed else torch.float32
    if model_type == "BBDM":
        model = BrownianBridgeModel(model_config, dtype=dtype, device=device)
    elif model_type == "LBBDM":
        model = LatentBrownianBridgeModel(model_config, dtype=dtype, device=device)
    elif model_type == "VQGAN":
        model = VQGANTrainModel(model_config, dtype=dtype, device=device)
    else:
        raise NotImplementedError(f"model_type {model_type!r}")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init_parameters(model, generator)
    return model.eval()
