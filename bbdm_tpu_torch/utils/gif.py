"""An animated GIF writer without Pillow, for ``save_images``'s ``movie.gif``
(``bbdm_tpu/runners/diffusion_base.py:45-49`` writes it with Pillow's
``save(..., save_all=True, duration=1, loop=0)``).

As Pillow writes it: GIF89a, a NETSCAPE2.0 loop count, a frame equal to the
one before it dropped, and a delay of ``duration // 10`` hundredths of a second
(0 for ``duration=1``). Each frame carries its own 256-colour palette, made by
median cut (:func:`median_cut`); the codes are LZW-packed by the host library
(``native/fastimage.cpp:gif_lzw``). Pillow's own quantizer is not matched: a
frame's colours may differ from Pillow's by a few levels.
"""

from __future__ import annotations

import struct

import numpy as np

from bbdm_tpu_torch.native.fastimage import gif_lzw


def median_cut(pixels: np.ndarray, colors: int = 256):
    """uint8 [N, 3] -> (palette uint8 [K, 3], K <= colors; index uint8 [N]).
    Boxes of distinct colours are split at the weighted median of their widest
    channel, the widest box first; each box's colour is its weighted mean, and
    each pixel takes the nearest palette colour."""
    flat = pixels.astype(np.int64)
    keys = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    uniq, inverse, counts = np.unique(keys, return_inverse=True, return_counts=True)
    rgb = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], axis=1)
    if len(uniq) <= colors:
        return rgb.astype(np.uint8), inverse.astype(np.uint8)

    def entry(box):
        span = np.ptp(rgb[box], axis=0)
        return int(span.max()), int(span.argmax()), box

    boxes = [entry(np.arange(len(uniq)))]
    while len(boxes) < colors:
        widest = max(range(len(boxes)), key=lambda i: boxes[i][0])
        span, ch, box = boxes[widest]
        if span == 0:
            break
        box = box[np.argsort(rgb[box, ch], kind="stable")]
        cum = np.cumsum(counts[box])
        cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2), 1, len(box) - 1))
        boxes[widest:widest + 1] = [entry(box[:cut]), entry(box[cut:])]
    palette = np.stack([np.rint((rgb[b] * counts[b][:, None]).sum(0) / counts[b].sum())
                        for _, _, b in boxes]).astype(np.int32)
    nearest = np.empty(len(uniq), np.uint8)
    for i in range(0, len(uniq), 8192):
        d = ((rgb[i:i + 8192, None, :].astype(np.int32) - palette[None]) ** 2).sum(-1)
        nearest[i:i + 8192] = d.argmin(1)
    return palette.astype(np.uint8), nearest[inverse]


def _blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def encode_gif(frames, duration: int = 1, loop: int = 0) -> bytes:
    """uint8 [H, W, 3] frames of one size -> GIF bytes."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    if not frames:
        raise ValueError("encode_gif: no frames")
    H, W = frames[0].shape[:2]
    if any(f.shape != (H, W, 3) for f in frames):
        raise ValueError("encode_gif: frames must all be uint8 [H, W, 3] of one size")
    out = [b"GIF89a", struct.pack("<HHBBB", W, H, 0, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0" + struct.pack("<BBHB", 3, 1, loop, 0)]
    prev = None
    for f in frames:
        if prev is not None and np.array_equal(f, prev):
            continue  # Pillow folds a repeated frame into the one before
        prev = f
        palette, index = median_cut(f.reshape(-1, 3))
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette
        out += [b"\x21\xf9\x04" + struct.pack("<BHBB", 0, duration // 10, 0, 0),
                b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0x87), table.tobytes(),
                b"\x08", _blocks(gif_lzw(index))]
    out.append(b"\x3b")
    return b"".join(out)


def write_gif(path: str, frames, duration: int = 1, loop: int = 0) -> None:
    with open(path, "wb") as f:
        f.write(encode_gif(frames, duration, loop))
