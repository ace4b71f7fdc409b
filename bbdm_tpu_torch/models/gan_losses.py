"""VQGAN training losses (port of ``bbdm_tpu/models/gan_losses.py``).

generator: nll + d_weight * disc_factor * g_loss + codebook_weight * q_loss,
the adaptive d_weight = |grad nll| / (|grad g| + 1e-4) at the decoder's last
layer, clipped to [0, 1e4] and scaled by ``disc_weight``; discriminator: hinge
or vanilla on the real and fake patch logits; ``adopt_weight`` zeroes the
adversarial terms before ``disc_start``. The reconstruction term adds the
LPIPS-VGG perceptual distance (``evaluation/lpips.py``) when a network is given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adopt_weight(weight, global_step, threshold=0, value=0.0):
    """``value`` before ``threshold`` steps, ``weight`` from then on."""
    return value if global_step < threshold else weight


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def reconstruction_loss(x, xrec, *, lpips=None, perceptual_weight=1.0):
    """|x - xrec| per element, plus ``perceptual_weight * lpips(x, xrec)`` per
    image where an LPIPS network is given (NCHW images in [-1, 1])."""
    rec = (x - xrec).abs()
    if lpips is not None and perceptual_weight > 0:
        rec = rec + perceptual_weight * lpips(x, xrec).view(-1, 1, 1, 1)
    return rec


def adaptive_d_weight(nll_grad_last, g_grad_last, disc_weight=1.0):
    """Balance the adversarial push against the reconstruction pull at the
    decoder's last layer (norms over all elements)."""
    w = torch.linalg.vector_norm(nll_grad_last) / (torch.linalg.vector_norm(g_grad_last) + 1e-4)
    return w.clamp(0.0, 1e4) * disc_weight
