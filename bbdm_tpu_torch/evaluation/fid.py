"""FID over two image directories (port of ``bbdm_tpu/evaluation/fid.py``).

Features come from :class:`FIDInceptionV3` on the CUDA card (the CPU when the
caller passes ``device="cpu"``); the Fréchet distance is scipy's matrix square
root in float64, as pytorch_fid computes it. Weights: ``weights_path`` or
``$BBDM_FID_WEIGHTS``, a torch ``.pth``/``.pt`` state dict (pytorch_fid's or
torchvision's) or the JAX package's converted tree (``.ckpt``/``.msgpack``).
Images are read with the port's PNG reader: a directory holding JPEG, BMP or
WebP files raises (``ROADMAP.md`` §1 item 11).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from scipy import linalg

from bbdm_tpu_torch.evaluation.inception import (
    FIDInceptionV3,
    inception_state_dict,
    state_dict_from_inception_tree,
)
from bbdm_tpu_torch.models.factory import resolve_device
from bbdm_tpu_torch.utils.images import read_png, to_rgb

IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d^2 = |mu1-mu2|^2 + tr(S1 + S2 - 2 sqrt(S1 S2)) (pytorch_fid semantics)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    def _sqrtm(m):
        res = linalg.sqrtm(m)  # scipy >= 1.18 returns the array alone
        return res[0] if isinstance(res, tuple) else res

    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def activation_statistics(features: np.ndarray):
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def image_files(path: str):
    """The sorted image files of a directory; any but PNG raises."""
    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if os.path.splitext(f)[1].lower() in IMAGE_EXTENSIONS)
    other = [f for f in files if os.path.splitext(f)[1].lower() != ".png"]
    if other:
        raise ValueError(f"{other[0]}: the PyTorch port reads PNG images only "
                         "(ROADMAP.md §1 item 11)")
    return files


def load_fid_params(weights_path: str | None = None) -> dict:
    """The state dict of :class:`FIDInceptionV3` from ``weights_path`` or
    ``$BBDM_FID_WEIGHTS``."""
    path = weights_path or os.environ.get("BBDM_FID_WEIGHTS")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "FID InceptionV3 weights not found. Set BBDM_FID_WEIGHTS to a "
            "torchvision/pytorch_fid InceptionV3 checkpoint (.pth) or a "
            "pre-converted .msgpack (this environment has no network egress, "
            "so weights cannot be auto-downloaded like pytorch_fid does)."
        )
    if path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        return inception_state_dict(sd)
    from bbdm_tpu_torch.checkpoints.io import load_checkpoint

    return state_dict_from_inception_tree(load_checkpoint(path))


def load_fid_model(weights_path: str | None = None, device=None) -> FIDInceptionV3:
    """:class:`FIDInceptionV3` with those weights on ``device`` (default the CUDA
    card, which raises where there is none)."""
    device = resolve_device(device)
    model = FIDInceptionV3()
    model.load_state_dict(load_fid_params(weights_path))
    return model.to(device)


def to_device(images: np.ndarray, device) -> torch.Tensor:
    """float32 NHWC host images -> NCHW on ``device`` (through pinned memory to a card)."""
    x = torch.from_numpy(images)
    if device.type == "cuda":
        x = x.pin_memory().to(device, non_blocking=True)
    return x.permute(0, 3, 1, 2).contiguous()


def read_images(files) -> np.ndarray:
    """float32 [N, H, W, 3] in [0, 1]."""
    return np.stack([to_rgb(read_png(f)).astype(np.float32) / 255.0 for f in files])


def compute_features_for_path(path: str, model: FIDInceptionV3, batch_size: int = 32) -> np.ndarray:
    """pool3 features [N, 2048] (float32) of a directory's images, computed on the
    model's device."""
    files = image_files(path)
    if not files:
        raise ValueError(f"no images found in {path}")
    device = model.Conv2d_1a_3x3.conv.weight.device
    feats = []
    with torch.inference_mode():
        for i in range(0, len(files), batch_size):
            feats.append(model(to_device(read_images(files[i:i + batch_size]), device)))
        return torch.cat(feats).cpu().numpy()


def calc_FID(input_path1: str, input_path2: str, *, weights_path: str | None = None,
             batch_size: int = 32, device=None) -> float:
    """FID between two directories of images (reference calc_FID signature)."""
    model = load_fid_model(weights_path, device)
    f1 = compute_features_for_path(input_path1, model, batch_size)
    f2 = compute_features_for_path(input_path2, model, batch_size)
    fid_value = frechet_distance(*activation_statistics(f1), *activation_statistics(f2))
    print("FID value:", fid_value)
    return fid_value
