"""Inputs made from the seed: paired images and the noise of each batch.

Images are procedural colour scenes (a colour gradient, gaussian blobs and
hard-edged rectangles) with their luma as the condition: a frozen copy of the
arithmetic of the measured program's synthetic colorization set, as it stood
when this benchmark was defined. Pair ``i`` of a run is drawn from
``numpy.random.RandomState`` seeded by the run's seed and ``i``, so every
seed gives the same amount of work and the same sizes, and one seed the same
inputs.
"""

from __future__ import annotations

import numpy as np
import torch

_MIX = 0x9E3779B1


def pair_seed(seed: int, i: int) -> int:
    return (seed * _MIX + i * 7919 + 1) % (2 ** 32)


def _gradient(rng, size):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    yy, xx = yy / (size - 1), xx / (size - 1)
    c0 = rng.uniform(0.05, 0.95, size=3).astype(np.float32)
    c1 = rng.uniform(0.05, 0.95, size=3).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi)
    t = (xx * np.cos(ang) + yy * np.sin(ang) + 1.0) / 2.0
    return c0[None, None] * (1 - t[..., None]) + c1[None, None] * t[..., None]


def _add_blobs(rng, img, n_blobs):
    h, w, _ = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(n_blobs):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        sy, sx = rng.uniform(0.05, 0.25) * h, rng.uniform(0.05, 0.25) * w
        color = rng.uniform(0, 1, size=3).astype(np.float32)
        alpha = rng.uniform(0.4, 0.9)
        g = np.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2))
        img = img * (1 - alpha * g[..., None]) + alpha * g[..., None] * color[None, None]
    return img


def _add_rects(rng, img, n_rects):
    h, w, _ = img.shape
    for _ in range(n_rects):
        rh, rw = int(rng.uniform(0.08, 0.3) * h), int(rng.uniform(0.08, 0.3) * w)
        y0, x0 = rng.randint(0, h - rh), rng.randint(0, w - rw)
        color = rng.uniform(0, 1, size=3).astype(np.float32)
        alpha = rng.uniform(0.5, 1.0)
        img[y0:y0 + rh, x0:x0 + rw] = img[y0:y0 + rh, x0:x0 + rw] * (1 - alpha) + alpha * color
    return img


def make_pair(seed: int, size: int):
    """(target, condition), float32 HWC in [-1, 1]: the scene and its luma."""
    rng = np.random.RandomState(seed)
    img = _add_rects(rng, _add_blobs(rng, _gradient(rng, size), rng.randint(3, 7)),
                     rng.randint(1, 4))
    img = np.clip(img, 0.0, 1.0)
    luma = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    cond = np.repeat(luma[..., None], 3, axis=-1)
    return (img * 2 - 1).astype(np.float32), (cond * 2 - 1).astype(np.float32)


def host_batch(seed: int, index: int, batch: int, size: int) -> dict:
    """Batch ``index`` in the test loader's contract: NHWC ``x`` and
    ``x_cond`` float32 and the name lists."""
    pairs = [make_pair(pair_seed(seed, index * batch + r), size) for r in range(batch)]
    names = [f"b{index:05d}_{r:03d}" for r in range(batch)]
    return {"x": np.stack([p[0] for p in pairs]), "x_cond": np.stack([p[1] for p in pairs]),
            "x_name": names, "x_cond_name": names}


def noise(seed: int, index: int, shape, device) -> torch.Tensor:
    """Standard normal noise of ``shape`` for batch or microbatch ``index``,
    drawn on ``device`` in one call."""
    g = torch.Generator(device).manual_seed(pair_seed(seed, index) + (1 << 40))
    return torch.randn(shape, generator=g, device=device)


def timesteps(seed: int, index: int, batch: int, num_timesteps: int, device) -> torch.Tensor:
    g = torch.Generator(device).manual_seed(pair_seed(seed, index) + (2 << 40))
    return torch.randint(0, num_timesteps, (batch,), generator=g, device=device)
