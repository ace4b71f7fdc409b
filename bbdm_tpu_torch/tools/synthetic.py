"""Synthetic paired translation datasets in the ``custom_aligned`` layout (port
of ``scripts/make_synthetic_dataset.py``):

    <out>/{train,val,test}/A/<stage>_<i:05d>.png   condition (from B, see --task)
    <out>/{train,val,test}/B/<stage>_<i:05d>.png   target (a procedural colour image)
    <out>/{val,test}/B_modes/<stage>_<i:05d>_m<k>.png   (--task stochastic only)

B is a random colour gradient with gaussian colour blobs and a few hard-edged
rectangles. The condition A of each task:

* ``colorization``: the ITU-R 601 luma of B on three channels (one-to-many: a
  posterior sampler cannot beat the copy-the-input floor here);
* ``restore``: ``gaussian_blur(1 - B[..., (1, 2, 0)])``, deterministic and
  invertible, so a trained sampler's PSNR can far exceed the floor;
* ``stochastic``: the restore degradation of the canonical scene, with B a
  uniformly random one of four global colour transforms of it (``_STOCH_MODES``);
  val and test also get every mode's rendering under ``B_modes/`` for scoring
  (``tools/stochastic_demo.py``).

Every pair comes from ``numpy.random.RandomState(seed + i)``, so a tree is
reproducible, and B is the same for every task at one ``--seed``. Val and test
seeds start at ``seed + 1_000_000`` and ``seed + 2_000_000``. The pixels are
the JAX script's, array for array; the files are written by the port's own
PNG encoder (``utils/images.write_png``) where the script uses Pillow, and
decode to the same arrays.

    python -m bbdm_tpu_torch.tools.synthetic --out datasets/synpix256 \\
        --task restore --size 256 --train 3000 --val 64 --test 64 [--cpu]

The generation runs on the host. As every entry point of the port, the command
takes the CUDA card and raises where there is none, unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _gradient(rng, size):
    """Random linear colour gradient background."""
    h = w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / (h - 1), xx / (w - 1)
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
        sy = rng.uniform(0.05, 0.25) * h
        sx = rng.uniform(0.05, 0.25) * w
        color = rng.uniform(0, 1, size=3).astype(np.float32)
        alpha = rng.uniform(0.4, 0.9)
        g = np.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2))
        img = img * (1 - alpha * g[..., None]) + alpha * g[..., None] * color[None, None]
    return img


def _add_rects(rng, img, n_rects):
    h, w, _ = img.shape
    for _ in range(n_rects):
        rh = int(rng.uniform(0.08, 0.3) * h)
        rw = int(rng.uniform(0.08, 0.3) * w)
        y0 = rng.randint(0, h - rh)
        x0 = rng.randint(0, w - rw)
        color = rng.uniform(0, 1, size=3).astype(np.float32)
        alpha = rng.uniform(0.5, 1.0)
        img[y0:y0 + rh, x0:x0 + rw] = (
            img[y0:y0 + rh, x0:x0 + rw] * (1 - alpha) + alpha * color[None, None])
    return img


def _conv1d_reflect(img, kernel, axis):
    r = len(kernel) // 2
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r, r)
    p = np.pad(img, pad, mode="reflect")
    out = np.zeros_like(img)
    for i, w in enumerate(kernel):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(i, i + img.shape[axis])
        out += w * p[tuple(sl)]
    return out


def _gaussian_blur(img, sigma):
    if sigma <= 0:
        return img
    r = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return _conv1d_reflect(_conv1d_reflect(img, k, 0), k, 1)


# the four global colour modes of the stochastic task's posterior: bijective,
# mutually distant transforms of the canonical scene (index = mode id)
_STOCH_MODES = (
    lambda c: c,                        # m0: identity
    lambda c: 1.0 - c,                  # m1: value inversion
    lambda c: c[..., [1, 2, 0]],        # m2: channel cycle
    lambda c: 1.0 - c[..., [2, 0, 1]],  # m3: inverted reverse cycle
)


def stochastic_modes(canonical):
    """All four target renderings of one canonical scene (float [0, 1] HWC)."""
    return [np.clip(m(canonical), 0.0, 1.0) for m in _STOCH_MODES]


def make_pair(seed, size, task="colorization", blur_sigma=4.0):
    """uint8 HWC (A, B) of pair ``seed``, and for the stochastic task the list
    of the four mode renderings as a third item."""
    rng = np.random.RandomState(seed)
    img = _gradient(rng, size)
    img = _add_blobs(rng, img, rng.randint(3, 7))
    img = _add_rects(rng, img, rng.randint(1, 4))
    img = np.clip(img, 0.0, 1.0)
    modes = None
    if task == "colorization":
        luma = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
        cond = np.repeat(luma[..., None], 3, axis=-1)
    elif task == "restore":
        cond = _gaussian_blur(1.0 - img[..., [1, 2, 0]], blur_sigma)
    elif task == "stochastic":
        # the condition pins the canonical scene (the invertible restore
        # degradation); the target is a uniformly random one of its modes
        cond = _gaussian_blur(1.0 - img[..., [1, 2, 0]], blur_sigma)
        modes = stochastic_modes(img)
        img = modes[rng.randint(len(modes))]
    else:
        raise ValueError(f"unknown task {task!r}")
    b = (img * 255.0 + 0.5).astype(np.uint8)
    a = (np.clip(cond, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    if modes is not None:
        return a, b, [(m * 255.0 + 0.5).astype(np.uint8) for m in modes]
    return a, b


def write_stage(out, stage, count, size, seed_base, task="colorization", blur_sigma=4.0):
    """Write ``count`` pairs of one stage; val and test of the stochastic task
    also get ``B_modes/`` (never train: the loader sees the sampled target only)."""
    from bbdm_tpu_torch.utils.images import write_png

    a_dir = os.path.join(out, stage, "A")
    b_dir = os.path.join(out, stage, "B")
    os.makedirs(a_dir, exist_ok=True)
    os.makedirs(b_dir, exist_ok=True)
    modes_dir = os.path.join(out, stage, "B_modes")
    want_modes = task == "stochastic" and stage != "train"
    if want_modes:
        os.makedirs(modes_dir, exist_ok=True)
    for i in range(count):
        pair = make_pair(seed_base + i, size, task=task, blur_sigma=blur_sigma)
        name = f"{stage}_{i:05d}.png"
        write_png(os.path.join(a_dir, name), pair[0])
        write_png(os.path.join(b_dir, name), pair[1])
        if want_modes:
            for k, mimg in enumerate(pair[2]):
                write_png(os.path.join(modes_dir, f"{stage}_{i:05d}_m{k}.png"), mimg)
    print(f"{stage}: {count} pairs -> {os.path.join(out, stage)}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", type=str, default="datasets/syn256")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--train", type=int, default=800)
    ap.add_argument("--val", type=int, default=64)
    ap.add_argument("--test", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--task", choices=("colorization", "restore", "stochastic"),
                    default="colorization")
    ap.add_argument("--blur-sigma", type=float, default=4.0,
                    help="restore-task blur stddev in pixels at --size")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    from bbdm_tpu_torch.models.factory import resolve_device

    args = parse_args(argv)
    resolve_device("cpu" if args.cpu else "cuda")  # no card: raise before any work
    kw = dict(task=args.task, blur_sigma=args.blur_sigma)
    write_stage(args.out, "train", args.train, args.size, args.seed, **kw)
    write_stage(args.out, "val", args.val, args.size, args.seed + 1_000_000, **kw)
    write_stage(args.out, "test", args.test, args.size, args.seed + 2_000_000, **kw)


if __name__ == "__main__":
    main()
