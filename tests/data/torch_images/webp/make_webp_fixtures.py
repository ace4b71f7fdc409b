"""Write the WebP fixtures of the PyTorch port's reader tests into this directory
(seeded; run from anywhere, with Pillow 12.1 and its bundled libwebp 1.6.0,
and OpenCV):

    python tests/data/torch_images/webp/make_webp_fixtures.py

Lossy (VP8) files are written by libwebp's own encoder, reached through ctypes
(``WebPConfigInitInternal`` / ``WebPEncode`` of the ``libwebp`` beside
Pillow), since Pillow's ``save`` cannot choose the loop filter, its strength
and sharpness, the segment count or the token partitions; each file's frame
header is read back (:func:`vp8_header`) to check that the encoder did as
asked (libwebp writes more than one token partition only at methods 0-2). They
cover the simple and the normal filter at strengths 0, 40 and 100 and
sharpness 0, 3 and 7, 1 and 4 segments, 1, 2, 4 and 8 partitions, q0 and q100,
the sizes 1x1, 1x17, 17x1, 15x13 and 33x47, and ALPH, compressed and raw.
Lossless (VP8L): methods 0 and 6, palettes of 2, 3, 4, 16 and 256 colours at
an odd width, ``exact`` with transparent pixels, near-lossless, and alpha.
Written by hand: two animations whose first frame (lossy, lossless) is smaller
than the canvas and offset, and a VP8X file with ICCP, XMP and an odd-sized
unknown chunk. ``exif_orientation6.webp``: an EXIF orientation of 6, which
``cv2.imread`` applies and Pillow does not. ``*_256.webp``: 256^2 files
whose decodes ``chip_smoke.py`` holds to their digests (a photo-like image at
q75 and q90, with ALPH, and lossless; that image quantized to 64 colours,
lossless); ``tree256/``: eight 256^2 images of its Paeth tree
(``chip_smoke.textured_u8``, seeds 512-519) saved by Pillow at q85, from which
it builds its ``custom_aligned`` WebP tree.

``expected.npz`` holds ``np.asarray(Image.open(f).convert("RGB"))`` of every
file but the 256^2 ones under its name, stored as ``../expected.npz`` stores
them (differences along W modulo 256: ``np.cumsum(stored, axis=1,
dtype=np.uint8)`` is the array); ``cv2.imread(f)[..., ::-1]`` of the EXIF file
under ``imread:<name>``, stored alike; and the SHA-256 of the array of each
256^2 file under ``sha256:<name>`` (``tree256/<name>`` for the tree).
"""

import ctypes
import glob
import hashlib
import io
import os
import struct

import cv2
import numpy as np
import PIL
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
ENCODER_ABI = 0x0210  # WEBP_ENCODER_ABI_VERSION of libwebp 1.6


def textured(h, w, c, seed):
    """Smooth gradients, an edge and some noise, uint8 [h, w, c] (as
    ``../make_fixtures.py``)."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(yy[..., None] / 5.0 + np.arange(c)) * 70 + (xx[..., None] * (200.0 / w))
            - 30 * (xx[..., None] > w // 2))
    return np.clip(base + 90 + rs.randint(0, 6, (h, w, c)), 0, 255).astype(np.uint8)


def photo_like(size, seed):
    """uint8 [size, size, 3]: sinusoids of six frequencies, blended rectangles
    and noise; at 256^2 it compresses about as a photograph does (q75: ~14 KB)."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    img = np.full((size, size, 3), 128.0)
    for k in range(1, 7):
        f = rs.uniform(-8, 8, 2) * k
        img += 60 / k * np.sin(2 * np.pi * (f[0] * yy + f[1] * xx)[..., None]
                               + rs.uniform(0, 2 * np.pi, 3))
    for _ in range(12):
        y0, x0 = rs.randint(0, size, 2)
        h, w = rs.randint(8, size // 3, 2)
        img[y0:y0 + h, x0:x0 + w] = 0.5 * img[y0:y0 + h, x0:x0 + w] + rs.uniform(0, 128, 3)
    return np.clip(img + rs.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def textured_u8(size, seed):
    """``chip_smoke.textured_u8``: the images of its 256^2 Paeth tree."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    img = np.sin(6 * yy[..., None] + 4 * xx[..., None] + rs.uniform(0, 2 * np.pi, 3))
    return np.clip(img * 100 + 128 + rs.randint(0, 12, (size, size, 3)), 0, 255).astype(np.uint8)


# ----------------------------------------------------------- libwebp's encoder

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


class _Config(ctypes.Structure):  # WebPConfig (src/webp/encode.h)
    _fields_ = [(n, _I) for n in ("lossless",)] + [("quality", _F)] + [
        (n, _I) for n in ("method", "image_hint", "target_size")] + [("target_PSNR", _F)] + [
        (n, _I) for n in ("segments", "sns_strength", "filter_strength", "filter_sharpness",
                          "filter_type", "autofilter", "alpha_compression", "alpha_filtering",
                          "alpha_quality", "pass_", "show_compressed", "preprocessing",
                          "partitions", "partition_limit", "emulate_jpeg_size", "thread_level",
                          "low_memory", "near_lossless", "exact", "use_delta_palette",
                          "use_sharp_yuv", "qmin", "qmax")] + [("pad", ctypes.c_uint32 * 8)]


class _Picture(ctypes.Structure):  # WebPPicture (src/webp/encode.h)
    _fields_ = [("use_argb", _I), ("colorspace", _I), ("width", _I), ("height", _I),
                ("y", _P), ("u", _P), ("v", _P), ("y_stride", _I), ("uv_stride", _I),
                ("a", _P), ("a_stride", _I), ("pad1", ctypes.c_uint32 * 2), ("argb", _P),
                ("argb_stride", _I), ("pad2", ctypes.c_uint32 * 3), ("writer", _P),
                ("custom_ptr", _P), ("extra_info_type", _I), ("extra_info", _P),
                ("stats", _P), ("error_code", _I), ("progress_hook", _P), ("user_data", _P),
                ("pad3", ctypes.c_uint32 * 3), ("pad4", _P), ("pad5", _P),
                ("pad6", ctypes.c_uint32 * 8), ("memory_", _P), ("memory_argb_", _P),
                ("pad7", _P * 2)]


class _Writer(ctypes.Structure):  # WebPMemoryWriter
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 1)]


def _libwebp():
    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
    ctypes.CDLL(glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))[0], mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*.so*"))[0])
    lib.WebPPictureImportRGBA.argtypes = lib.WebPPictureImportRGB.argtypes = [
        ctypes.POINTER(_Picture), _P, _I]
    return lib


_LIB = None


def libwebp_encode(img, **options):
    """uint8 [h, w, 3 or 4] -> the bytes ``WebPEncode`` writes with the
    ``WebPConfig`` fields in ``options`` set over the default preset."""
    global _LIB
    _LIB = _LIB or _libwebp()
    cfg = _Config()
    assert _LIB.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(75.0), ENCODER_ABI)
    for k, v in options.items():
        setattr(cfg, k, v)
    assert _LIB.WebPValidateConfig(ctypes.byref(cfg)), options
    pic = _Picture()
    assert _LIB.WebPPictureInitInternal(ctypes.byref(pic), ENCODER_ABI)
    img = np.ascontiguousarray(img, np.uint8)
    pic.height, pic.width = img.shape[:2]
    pic.use_argb = cfg.lossless
    imp = _LIB.WebPPictureImportRGBA if img.shape[2] == 4 else _LIB.WebPPictureImportRGB
    assert imp(ctypes.byref(pic), img.ctypes.data, img.shape[1] * img.shape[2])
    writer = _Writer()
    _LIB.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(_LIB.WebPMemoryWrite, _P).value
    pic.custom_ptr = ctypes.addressof(writer)
    ok = _LIB.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    error = pic.error_code
    _LIB.WebPPictureFree(ctypes.byref(pic))
    assert ok, f"WebPEncode failed ({error}) for {options}"
    data = ctypes.string_at(writer.mem, writer.size)
    _LIB.WebPMemoryWriterClear(ctypes.byref(writer))
    return data


# ----------------------------------------------------------- the VP8 header, read back

class _BoolDecoder:
    """RFC 6386's boolean decoder (section 7.3)."""

    def __init__(self, data):
        self.data, self.pos = data, 2
        self.value, self.range, self.count = (data[0] << 8) | data[1], 255, 0

    def bit(self, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            b, self.range, self.value = 1, self.range - split, self.value - (split << 8)
        else:
            b, self.range = 0, split
        while self.range < 128:
            self.value, self.range, self.count = self.value << 1, self.range << 1, self.count + 1
            if self.count == 8:
                self.count = 0
                self.value |= self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
        return b

    def value_of(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v


def chunks(data):
    """(fourcc, payload) of a RIFF file's top-level chunks."""
    pos, out = 12, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack("<I", data[pos + 4:pos + 8])
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def vp8_header(data):
    """(segments on, filter type "simple"/"normal", level, sharpness, token
    partitions) of the first VP8 chunk of a WebP file."""
    vp8 = next(body for tag, body in chunks(data) if tag == b"VP8 ")
    br = _BoolDecoder(vp8[10:])
    br.value_of(2)  # colour space, clamping
    segments = br.bit(128)
    if segments:
        update_map, update_data = br.bit(128), br.bit(128)
        if update_data:
            br.bit(128)
            for bits in (7,) * 4 + (6,) * 4:
                if br.bit(128):
                    br.value_of(bits + 1)
        if update_map:
            for _ in range(3):
                if br.bit(128):
                    br.value_of(8)
    simple, level, sharpness = br.bit(128), br.value_of(6), br.value_of(3)
    if br.bit(128) and br.bit(128):  # loop filter deltas, updated
        for _ in range(8):
            if br.bit(128):
                br.value_of(7)
    return segments, "simple" if simple else "normal", level, sharpness, 1 << br.value_of(2)


# ----------------------------------------------------------- hand-made containers

def chunk(tag, body):
    return tag + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def riff(*parts):
    body = b"WEBP" + b"".join(parts)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def u24(v):
    return struct.pack("<I", v)[:3]


def image_chunks(webp):
    """The chunks after a simple or VP8X file's header chunk (ALPH and VP8, or VP8L)."""
    out = chunks(webp)
    return b"".join(chunk(t, b) for t, b in out if t != b"VP8X")


def animation(frames, canvas):
    """A VP8X animation: frames are (x, y, WebP bytes), offsets even."""
    w, h = canvas
    anmf = []
    for x, y, webp in frames:
        fw, fh = Image.open(io.BytesIO(webp)).size
        anmf.append(chunk(b"ANMF", u24(x // 2) + u24(y // 2) + u24(fw - 1) + u24(fh - 1)
                          + u24(100) + b"\0" + image_chunks(webp)))
    return riff(chunk(b"VP8X", bytes([0x12, 0, 0, 0]) + u24(w - 1) + u24(h - 1)),
                chunk(b"ANIM", bytes([40, 80, 120, 255]) + struct.pack("<H", 0)), *anmf)


def pillow_save(img, **options):
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="WEBP", **options)
    return b.getvalue()


def palette_image(h, w, colors, channels, seed):
    """uint8 [h, w, channels] of exactly `colors` distinct colours, runs of 3."""
    codes = np.random.RandomState(seed).choice(1 << (8 * channels), colors, replace=False)
    pal = (codes[:, None] >> (8 * np.arange(channels))).astype(np.uint8)
    return pal[np.arange(h * w).reshape(h, w) // 3 % colors]


def main():
    files = {}
    rgb = textured(33, 47, 3, 10)
    lossy = dict(quality=75.0, autofilter=0)
    for name, opts, want in (
            ("vp8_simple_f100_s0", dict(filter_type=0, filter_strength=100, filter_sharpness=0),
             ("simple", 0)),
            ("vp8_simple_f100_s7", dict(filter_type=0, filter_strength=100, filter_sharpness=7),
             ("simple", 7)),
            ("vp8_simple_f40_s3", dict(filter_type=0, filter_strength=40, filter_sharpness=3),
             ("simple", 3)),
            ("vp8_normal_f100_s0", dict(filter_type=1, filter_strength=100, filter_sharpness=0),
             ("normal", 0)),
            ("vp8_normal_f100_s7", dict(filter_type=1, filter_strength=100, filter_sharpness=7),
             ("normal", 7)),
            ("vp8_normal_f40_s3", dict(filter_type=1, filter_strength=40, filter_sharpness=3),
             ("normal", 3)),
            ("vp8_filter_f0", dict(filter_type=1, filter_strength=0), None)):
        data = libwebp_encode(rgb, **lossy, segments=1, **opts)
        _, kind, level, sharpness, _ = vp8_header(data)
        if want is None:
            assert level == 0, name
        else:
            assert (kind, sharpness) == want and level > 0, (name, kind, level, sharpness)
        files[f"{name}.webp"] = data
    for segments in (1, 4):
        data = libwebp_encode(textured(48, 64, 3, 11), **lossy, segments=segments,
                              sns_strength=100)
        assert vp8_header(data)[0] == (segments > 1), segments
        files[f"vp8_seg{segments}.webp"] = data
    for log2 in range(4):  # methods 3-6 write one partition whatever is asked
        data = libwebp_encode(textured(144, 40, 3, 12), **lossy, partitions=log2, method=log2 % 3)
        assert vp8_header(data)[4] == 1 << log2
        files[f"vp8_part{1 << log2}.webp"] = data
    for q in (0, 100):
        files[f"vp8_q{q}.webp"] = libwebp_encode(rgb, quality=float(q), filter_strength=60)
    for h, w in ((1, 1), (1, 17), (17, 1), (15, 13), (33, 47)):
        files[f"vp8_{h}x{w}.webp"] = libwebp_encode(textured(h, w, 3, h * w), quality=80.0)
    rgba = textured(33, 47, 4, 13)  # alpha: a smooth ramp (noise compresses worse than raw)
    rgba[..., 3] = np.clip(np.add.outer(np.arange(33) * 4, np.arange(47) * 3), 0, 255)
    for name, compression in (("compressed", 1), ("raw", 0)):
        data = libwebp_encode(rgba, quality=70.0, alpha_compression=compression)
        assert [t for t, _ in chunks(data)][:2] == [b"VP8X", b"ALPH"], name
        assert dict(chunks(data))[b"ALPH"][0] & 3 == compression, name
        files[f"vp8_alph_{name}.webp"] = data

    photo = textured(37, 53, 3, 14)
    for method in (0, 6):
        files[f"vp8l_m{method}.webp"] = libwebp_encode(photo, lossless=1, quality=75.0,
                                                       method=method)
    for colors in (2, 3, 4, 16, 256):
        img = palette_image(29, 37, colors, 3, colors)
        assert len(np.unique(img.reshape(-1, 3), axis=0)) == colors
        files[f"vp8l_pal{colors}.webp"] = libwebp_encode(img, lossless=1, quality=75.0,
                                                         method=4)
    clear = textured(37, 53, 4, 15)
    clear[..., 3] = np.where(np.add.outer(np.arange(37), np.arange(53)) % 17 < 6, 0, 255)
    files["vp8l_exact.webp"] = libwebp_encode(clear, lossless=1, quality=75.0, exact=1)
    files["vp8l_near_lossless.webp"] = libwebp_encode(photo, lossless=1, quality=75.0,
                                                      near_lossless=60)
    files["vp8l_alpha.webp"] = libwebp_encode(rgba, lossless=1, quality=90.0, method=5)
    for name in files:
        expected_tag = b"VP8L" if name.startswith("vp8l_") else b"VP8 "
        assert expected_tag in [t for t, _ in chunks(files[name])], name

    files["anim_vp8.webp"] = animation(
        [(6, 8, libwebp_encode(textured(13, 17, 3, 16), quality=80.0)),
         (0, 0, libwebp_encode(textured(30, 40, 3, 17), quality=80.0))], (40, 30))
    files["anim_vp8l.webp"] = animation(
        [(10, 4, libwebp_encode(textured(19, 11, 4, 18), lossless=1, quality=75.0)),
         (2, 2, libwebp_encode(textured(20, 20, 4, 19), lossless=1, quality=75.0))], (27, 31))
    small = libwebp_encode(textured(14, 18, 3, 20), quality=85.0)
    files["vp8x_chunks.webp"] = riff(
        chunk(b"VP8X", bytes([0x24, 0, 0, 0]) + u24(17) + u24(13)),
        chunk(b"ICCP", bytes(range(37))), chunk(b"ABCD", b"odd"), image_chunks(small),
        chunk(b"XMP ", b"<x:xmpmeta/>"))
    exif = Image.Exif()
    exif[0x0112] = 6
    files["exif_orientation6.webp"] = pillow_save(textured(13, 22, 3, 6), quality=90,
                                                  exif=exif.tobytes())
    assert b"EXIF" in [t for t, _ in chunks(files["exif_orientation6.webp"])]

    photo = photo_like(256, 21)
    big = {"vp8_q75_256.webp": libwebp_encode(photo, quality=75.0),
           "vp8_q90_256.webp": libwebp_encode(photo, quality=90.0)}
    rgba = np.concatenate([photo, np.clip(np.add.outer(np.arange(256), np.arange(256)), 0,
                                          255).astype(np.uint8)[..., None]], axis=2)
    big["vp8_alph_256.webp"] = libwebp_encode(rgba, quality=75.0)
    big["vp8l_photo_256.webp"] = libwebp_encode(photo, lossless=1, quality=75.0)
    quantized = np.asarray(Image.fromarray(photo).quantize(64).convert("RGB"))
    big["vp8l_palette_256.webp"] = libwebp_encode(quantized, lossless=1, quality=75.0)
    tree = {f"tree256/{i:04d}.webp": pillow_save(textured_u8(256, 512 + i), quality=85)
            for i in range(8)}

    expected, digests = {}, {}
    os.makedirs(os.path.join(HERE, "tree256"), exist_ok=True)
    for name, data in sorted({**files, **big, **tree}.items()):
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        arr = np.asarray(Image.open(path).convert("RGB"))
        if name in files:
            expected[name] = arr
        else:
            digests[f"sha256:{name}"] = np.frombuffer(hashlib.sha256(arr.tobytes()).digest(),
                                                      np.uint8)
    expected["imread:exif_orientation6.webp"] = np.ascontiguousarray(
        cv2.imread(os.path.join(HERE, "exif_orientation6.webp"))[..., ::-1])
    stored = {k: np.diff(v.astype(np.int16), axis=1, prepend=0).astype(np.uint8)
              for k, v in expected.items()}
    np.savez_compressed(os.path.join(HERE, "expected.npz"), **stored, **digests)


if __name__ == "__main__":
    main()
