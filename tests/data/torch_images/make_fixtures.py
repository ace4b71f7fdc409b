"""Write the image fixtures of the PyTorch port's reader tests into this
directory, with Pillow and OpenCV (run from anywhere; seeded):

    python tests/data/torch_images/make_fixtures.py

JPEG: 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1 sampling, progressive, grayscale
and with restart markers, at odd sizes. PNG: a palette with tRNS, 1-, 2-, 4-
and 16-bit samples, and Adam7 interlace (written by :func:`png_bytes`:
Pillow writes no interlaced PNG). BMP: 24-bit, 32-bit (OpenCV's BI_BITFIELDS),
8-bit and 4-bit palettes (the 4-bit one by :func:`bmp4_bytes`), top-down.
Two files that ``cv2.imread`` turns upright and Pillow does not: a JPEG whose
EXIF (APP1) orientation is 6 and a PNG whose ``eXIf`` orientation is 8. One
WebP. ``jpeg256/``: three 256^2 JPEGs (4:2:0, 4:4:4, progressive 4:2:0)
whose decodes ``chip_smoke.py`` holds to their digests on the card's host.

``expected.npz`` holds ``np.asarray(Image.open(f).convert("RGB"))`` of every
fixture of this directory but the WebP under its file name, each uint8
[H, W, 3] stored as its differences along W modulo 256 (they compress to
half: ``np.cumsum(stored, axis=1, dtype=np.uint8)`` is the array); OpenCV's
``cvtColor(cv2.imread(f), COLOR_BGR2LAB)`` of LAB_NAMES (four JPEGs, the
16-bit gray PNG, which ``cv2.imread`` keeps as its high byte, and the two
EXIF-rotated files) under
``lab:<name>``, stored alike; and the SHA-256 of the decoded array of each
``jpeg256/`` file under ``sha256:jpeg256/<name>``.
"""

import hashlib
import io
import os
import struct
import zlib

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
LAB_NAMES = ("q85_420.jpg", "q80_440.jpg", "q75_420_progressive.jpg", "q90_gray.jpg",
             "gray_16bit.png", "exif_orientation6.jpg", "exif_orientation8.png")
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))


def textured(h, w, c, seed):
    """Smooth gradients, an edge and some noise, uint8 [h, w, c]."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(yy[..., None] / 5.0 + np.arange(c)) * 70 + (xx[..., None] * (200.0 / w))
            - 30 * (xx[..., None] > w // 2))
    return np.clip(base + 90 + rs.randint(0, 6, (h, w, c)), 0, 255).astype(np.uint8)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _pack(samples, depth):
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    flat = samples.reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat
    per = 8 // depth
    flat = np.concatenate([flat, np.zeros((h, (-flat.shape[1]) % per), np.uint8)], 1)
    shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
    return (flat.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _filtered(rows, bpp, filters):
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for r, cur in enumerate(rows.astype(np.int64)):
        f = filters[r % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        out.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def png_bytes(samples, depth, color, interlace=0, filters=(0, 1, 2, 3, 4), palette=None,
              trns=None):
    """A PNG of samples [H, W, C] at any bit depth, rows filtered in turn by ``filters``."""
    H, W, C = samples.shape
    bpp = max(1, depth * C // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b"".join(_filtered(_pack(samples[y0::dy, x0::dx], depth), bpp, filters)
                   for y0, x0, dy, dx in passes if samples[y0::dy, x0::dx].size)
    extra = (_chunk(b"PLTE", palette) if palette is not None else b"") + (
        _chunk(b"tRNS", trns) if trns is not None else b"")
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, interlace))
            + extra + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def bmp4_bytes(index, palette, top_down=False):
    """A 4-bit palette BMP (Pillow writes none)."""
    H, W = index.shape
    stride = (W * 4 + 31) // 32 * 4
    packed = np.zeros((H, stride), np.uint8)
    packed[:, :(W + 1) // 2] = _pack(index[..., None], 4)
    rows = packed if top_down else packed[::-1]
    pal = b"".join(bytes([b, g, r, 0]) for r, g, b in palette)
    off = 14 + 40 + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + rows.size, 0, 0, off)
            + struct.pack("<IiiHHIIiiII", 40, W, -H if top_down else H, 1, 4, 0, rows.size,
                          2835, 2835, 16, 0) + pal + rows.tobytes())


def main():
    files = {}
    rgb = textured(37, 53, 3, 0)
    for name, sub in (("q85_444", 0), ("q85_422", 1), ("q85_420", 2)):
        b = io.BytesIO()
        Image.fromarray(rgb).save(b, format="JPEG", quality=85, subsampling=sub)
        files[f"{name}.jpg"] = b.getvalue()
    b = io.BytesIO()
    Image.fromarray(textured(53, 37, 3, 1)).save(b, format="JPEG", quality=75, progressive=True)
    files["q75_420_progressive.jpg"] = b.getvalue()
    b = io.BytesIO()
    Image.fromarray(textured(29, 41, 1, 2)[..., 0]).save(b, format="JPEG", quality=90)
    files["q90_gray.jpg"] = b.getvalue()
    for name, flags in (
            ("q80_440", [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]),
            ("q80_411", [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]),
            ("q80_420_restart", [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
            ("q80_progressive_restart", [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, 3])):
        ok, enc = cv2.imencode(".jpg", textured(37, 53, 3, len(files))[..., ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, 80] + flags)
        assert ok
        files[f"{name}.jpg"] = enc.tobytes()

    for name, fmt, orientation in (("exif_orientation6.jpg", "JPEG", 6),
                                   ("exif_orientation8.png", "PNG", 8)):
        exif = Image.Exif()
        exif[0x0112] = orientation
        b = io.BytesIO()
        Image.fromarray(textured(13, 22, 3, orientation)).save(b, format=fmt, quality=90,
                                                               exif=exif.tobytes())
        files[name] = b.getvalue()

    rs = np.random.RandomState(3)
    pal16 = rs.randint(0, 256, (16, 3)).astype(np.uint8)
    idx = rs.randint(0, 20, (21, 19, 1))  # indices past the palette read black
    files["palette_trns.png"] = png_bytes(idx, 8, 3, palette=pal16.tobytes(),
                                          trns=bytes(range(0, 256, 16)))
    files["palette_4bit_interlaced.png"] = png_bytes(rs.randint(0, 16, (37, 53, 1)), 4, 3,
                                                     interlace=1, palette=pal16.tobytes())
    files["gray_1bit.png"] = png_bytes(rs.randint(0, 2, (23, 37, 1)), 1, 0)
    files["gray_2bit.png"] = png_bytes(rs.randint(0, 4, (23, 37, 1)), 2, 0)
    files["gray_4bit_interlaced.png"] = png_bytes(rs.randint(0, 16, (23, 37, 1)), 4, 0,
                                                  interlace=1)
    files["gray_16bit.png"] = png_bytes(rs.randint(0, 600, (23, 37, 1)), 16, 0)
    files["rgb_16bit.png"] = png_bytes(rs.randint(0, 65536, (23, 37, 3)), 16, 2)
    files["gray_alpha_16bit.png"] = png_bytes(rs.randint(0, 65536, (23, 37, 2)), 16, 4)
    files["rgba_interlaced.png"] = png_bytes(textured(37, 53, 4, 4), 8, 6, interlace=1)
    b = io.BytesIO()
    Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE).save(b, format="PNG")
    files["pillow_palette.png"] = b.getvalue()

    small = textured(21, 29, 3, 6)
    for name, mode in (("rgb24.bmp", "RGB"), ("palette8.bmp", "P"), ("gray8.bmp", "L")):
        b = io.BytesIO()
        Image.fromarray(small).convert(mode).save(b, format="BMP")
        files[name] = b.getvalue()
    ok, enc = cv2.imencode(".bmp", textured(21, 29, 4, 5))
    files["bgra32_bitfields.bmp"] = enc.tobytes()
    files["palette4_top_down.bmp"] = bmp4_bytes(rs.randint(0, 16, (21, 37)), pal16,
                                                top_down=True)
    b = io.BytesIO()
    Image.fromarray(rgb).save(b, format="WEBP", quality=80)
    files["image.webp"] = b.getvalue()

    expected = {}
    for name, data in sorted(files.items()):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        if name.endswith(".webp"):
            continue
        expected[name] = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        if name in LAB_NAMES:
            bgr = cv2.imread(os.path.join(HERE, name))
            expected[f"lab:{name}"] = cv2.cvtColor(bgr, cv2.COLOR_BGR2LAB)
    stored = {k: np.diff(v.astype(np.int16), axis=1, prepend=0).astype(np.uint8)
              for k, v in expected.items()}
    os.makedirs(os.path.join(HERE, "jpeg256"), exist_ok=True)
    big = textured(256, 256, 3, 7)
    for name, kw in (("q85_420.jpg", dict(subsampling=2)), ("q85_444.jpg", dict(subsampling=0)),
                     ("q85_420_progressive.jpg", dict(subsampling=2, progressive=True))):
        b = io.BytesIO()
        Image.fromarray(big).save(b, format="JPEG", quality=85, **kw)
        with open(os.path.join(HERE, "jpeg256", name), "wb") as f:
            f.write(b.getvalue())
        digest = hashlib.sha256(np.asarray(Image.open(b).convert("RGB")).tobytes()).digest()
        stored[f"sha256:jpeg256/{name}"] = np.frombuffer(digest, np.uint8)
    np.savez_compressed(os.path.join(HERE, "expected.npz"), **stored)


if __name__ == "__main__":
    main()
