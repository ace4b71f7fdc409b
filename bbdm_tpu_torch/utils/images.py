"""Images without Pillow: float HWC -> uint8 -> PNG through zlib, image files
-> uint8, and sample grids.

``to_uint8`` has the arithmetic of ``bbdm_tpu/utils/images.py:15-22``
(mul(0.5).add(0.5).clamp(0,1).mul(255).add(0.5).clamp(0,255));
``get_image_grid`` its torchvision ``make_grid`` layout (``:30-45``).

:func:`read_image` reads what the JAX package reads with
``PIL.Image.open(path).convert("RGB")``, chosen by the file's signature: PNG
(every colour type and bit depth, palettes, Adam7 interlace; the row filters
undone by the host library, ``native/fastimage.cpp``), JPEG (the host
library's decoder, ``native/jpeg.cpp``), BMP (uncompressed 24/32-bit and
1/4/8-bit palettes) and WebP (lossy, lossless, with alpha, an animation's
first frame; the host library's decoder, ``native/webp.cpp``). With
``imread=True`` it reads as ``cv2.imread`` does instead (the JAX package's
``custom_colorization_LAB``): the EXIF orientation applied and 16-bit gray
kept as its high byte.

:func:`read_png` and :func:`decode_png` are the plain version of the 8-bit PNG
path, in numpy and Python: None, Sub and Up rows are undone in numpy; Average
and Paeth rows depend on the pixel to their left, so they are undone byte by
byte in Python (:func:`_unfilter_sequential`), which costs far more host time
per row. They take 8-bit gray, gray+alpha, RGB and RGBA, not interlaced, and
raise on anything else.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from bbdm_tpu_torch.native.fastimage import decode_jpeg, decode_webp, unfilter

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_uint8(image: np.ndarray, to_normal: bool = True) -> np.ndarray:
    img = np.asarray(image, dtype=np.float32)
    if to_normal:
        img = np.clip(img * 0.5 + 0.5, 0.0, 1.0)
    return np.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type (gray, gray+a, rgb, rgba)
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, C] (C in 1..4) -> PNG bytes (8 bit, no filtering)."""
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    if C not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes 1 to 4 channels, got {C}")
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], axis=1)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def save_single_image(image, save_path: str, file_name: str, to_normal: bool = True):
    """Write one float HWC image as ``save_path/file_name`` (PNG)."""
    os.makedirs(save_path, exist_ok=True)
    write_png(os.path.join(save_path, file_name), to_uint8(image, to_normal))


def get_image_grid(batch: np.ndarray, grid_size: int = 4, to_normal: bool = True,
                   padding: int = 2) -> np.ndarray:
    """[B, H, W, C] floats -> one uint8 [gH, gW, C] grid (torchvision make_grid layout)."""
    batch = np.asarray(batch)
    B, H, W, C = batch.shape
    ncol = min(grid_size, B)
    nrow = (B + ncol - 1) // ncol
    grid = np.zeros((nrow * (H + padding) + padding, ncol * (W + padding) + padding, C),
                    dtype=np.float32)
    for i in range(B):
        r, c = divmod(i, ncol)
        y, x = padding + r * (H + padding), padding + c * (W + padding)
        grid[y:y + H, x:x + W] = batch[i]
    return to_uint8(grid, to_normal)


# ------------------------------------------------------------------ reading

def _unfilter_sequential(ftype: int, raw: bytes, prev: bytes, bpp: int) -> bytes:
    """Average (3) or Paeth (4) row: each byte adds a predictor of its left
    neighbour (already decoded), so the row is walked in order."""
    cur = bytearray(raw)
    if ftype == 3:
        for i in range(bpp):
            cur[i] = (cur[i] + (prev[i] >> 1)) & 0xFF
        for i in range(bpp, len(cur)):
            cur[i] = (cur[i] + ((cur[i - bpp] + prev[i]) >> 1)) & 0xFF
        return bytes(cur)
    for i in range(bpp):  # no left or upper-left pixel: the predictor is the upper one
        cur[i] = (cur[i] + prev[i]) & 0xFF
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], prev[i], prev[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - c - c)
        cur[i] = (cur[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 0xFF
    return bytes(cur)


def _unfilter(data: bytes, H: int, W: int, bpp: int) -> np.ndarray:
    stride = W * bpp
    rows = np.frombuffer(data, np.uint8)
    if rows.size != H * (stride + 1):
        raise ValueError(f"PNG image data holds {rows.size} bytes, expected {H * (stride + 1)}")
    rows = rows.reshape(H, stride + 1)
    ftypes, raw = rows[:, 0], rows[:, 1:]
    out = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(H):
        f = int(ftypes[r])
        if f == 0:
            out[r] = raw[r]
        elif f == 1:  # Sub: a running sum mod 256 over each channel
            out[r] = np.cumsum(raw[r].reshape(W, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:  # Up
            out[r] = raw[r] + prev
        elif f in (3, 4):
            out[r] = np.frombuffer(_unfilter_sequential(f, raw[r].tobytes(), prev.tobytes(),
                                                        bpp), np.uint8)
        else:
            raise ValueError(f"PNG row filter {f}")
        prev = out[r]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C] with C = 1 (gray), 2 (gray+alpha), 3 or 4."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG chunk")
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad length or CRC")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind != b"PLTE" and not kind[0] & 0x20:  # an unknown critical chunk
            raise ValueError(f"PNG chunk {kind.decode('latin-1')!r} is not supported")
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    W, H, depth, color, compression, filt, interlace = header
    if depth != 8 or color not in _CHANNELS or compression or filt or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {color}, interlace "
                         f"{interlace}: only 8-bit gray, gray+alpha, RGB and RGBA, not "
                         "interlaced, are supported")
    C = _CHANNELS[color]
    return _unfilter(zlib.decompress(b"".join(idat)), H, W, C).reshape(H, W, C)


def read_png(path: str) -> np.ndarray:
    """uint8 [H, W, C] of a PNG file; any other format raises (the port reads
    images without Pillow)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data)
    except (ValueError, zlib.error) as e:
        raise ValueError(f"{path}: {e} (the PyTorch port reads 8-bit PNG only; it does "
                         "not use Pillow)") from None


def to_rgb(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] -> [H, W, 3] as Pillow's ``convert('RGB')``: gray is
    repeated, alpha dropped."""
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


# ------------------------------------------------------------ every format

_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))  # (row start, column start, row step, column step) of each pass
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def png_chunks(data: bytes):
    """(IHDR fields, PLTE bytes or None, inflated image data) of a PNG; the
    chunks' lengths and CRCs are checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG chunk")
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        if pos + 12 + n > len(data):
            raise ValueError(f"PNG chunk {kind!r}: truncated")
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(body, zlib.crc32(kind)) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif not kind[0] & 0x20:  # an unknown critical chunk
            raise ValueError(f"PNG chunk {kind.decode('latin-1')!r} is not supported")
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    W, H, depth, color, compression, filt, interlace = header
    if (color not in PNG_CHANNELS or depth not in (1, 2, 4, 8, 16) or compression or filt
            or interlace > 1 or (color in (2, 4, 6) and depth < 8)
            or (color == 3 and (depth > 8 or palette is None))):
        raise ValueError(f"PNG of bit depth {depth}, colour type {color}, compression "
                         f"{compression}, filter {filt}, interlace {interlace} is not valid")
    return header, palette, inflate(b"".join(idat))


def inflate(data: bytes) -> bytes:
    """zlib.decompress through a decompress object, which releases the GIL while
    it inflates (CPython 3.12's one-shot ``zlib.decompress`` holds it), so
    loader threads inflate in parallel."""
    d = zlib.decompressobj()
    out = d.decompress(data)
    if not d.eof:
        raise ValueError("incomplete or truncated zlib stream")
    return out


def _png_samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, width, channels] (uint8, or
    uint16 at depth 16)."""
    h = rows.shape[0]
    if depth == 16:
        return rows[:, :width * channels * 2].view(">u2").astype(np.uint16).reshape(
            h, width, channels)
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    per = 8 // depth  # samples per byte, the first in the high bits
    shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width, None]


def _png_rgb(samples: np.ndarray, depth: int, color: int, palette: bytes | None,
             imread: bool = False) -> np.ndarray:
    """Samples -> uint8 [H, W, 3] as Pillow's ``convert("RGB")`` makes them:
    16-bit samples keep their high byte (gray: min(v, 255), as Pillow's "I;16"
    converts; with ``imread`` the high byte, as ``cv2.imread`` keeps it),
    low-depth gray is scaled to 0..255, palette indices past the palette are
    black, alpha and tRNS are dropped."""
    if color == 3:
        lut = np.zeros((256, 3), np.uint8)
        pal = np.frombuffer(palette, np.uint8)[:len(palette) // 3 * 3].reshape(-1, 3)[:256]
        lut[:len(pal)] = pal
        return lut[samples[..., 0]]
    if depth == 16:
        samples = (np.minimum(samples, 255) if color == 0 and not imread
                   else samples >> 8).astype(np.uint8)
    elif depth < 8:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    return to_rgb(samples)


def decode_png_rgb(data: bytes, imread: bool = False) -> np.ndarray:
    """Any PNG -> uint8 [H, W, 3] equal to Pillow's ``convert("RGB")`` (16-bit
    gray as ``cv2.imread`` reads it with ``imread``)."""
    (W, H, depth, color, _, _, interlace), palette, raw = png_chunks(data)
    ch = PNG_CHANNELS[color]
    bpp = max(1, depth * ch // 8)
    if not interlace:
        stride = (W * ch * depth + 7) // 8
        return _png_rgb(_png_samples(unfilter(raw, H, stride, bpp), W, depth, ch), depth,
                        color, palette, imread)
    samples = np.zeros((H, W, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for y0, x0, dy, dx in _ADAM7:
        h, w = (H - y0 + dy - 1) // dy, (W - x0 + dx - 1) // dx
        if h <= 0 or w <= 0:
            continue
        stride = (w * ch * depth + 7) // 8
        n = h * (stride + 1)
        samples[y0::dy, x0::dx] = _png_samples(unfilter(raw[pos:pos + n], h, stride, bpp), w,
                                               depth, ch)
        pos += n
    if pos != len(raw):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected {pos}")
    return _png_rgb(samples, depth, color, palette, imread)


def decode_bmp_rgb(data: bytes) -> np.ndarray:
    """An uncompressed BMP (24 or 32 bits, or a 1/4/8-bit palette; bottom-up
    or top-down; 32-bit BI_BITFIELDS with byte-aligned masks) -> uint8 [H, W, 3]
    equal to Pillow's ``convert("RGB")``."""
    if data[:2] != b"BM" or len(data) < 26:
        raise ValueError("not a BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    (hsize,) = struct.unpack("<I", data[14:18])
    if hsize == 12:  # OS/2 core header
        W, H, _, bits = struct.unpack("<hhHH", data[18:26])
        compression, colors, entry = 0, 0, 3
    elif hsize >= 40:
        W, H, _, bits, compression, _, _, _, colors = struct.unpack("<iiHHIIiiI", data[18:50])
        entry = 4
    else:
        raise ValueError(f"BMP header of {hsize} bytes is not supported")
    top_down = H < 0
    H = abs(H)
    if W <= 0 or H == 0:
        raise ValueError(f"BMP of size {W}x{H}")
    masks = None
    if compression == 3 and bits == 32:  # R, G, B masks just after the 40-byte header
        masks = struct.unpack("<III", data[54:66])
    elif compression != 0:
        raise ValueError(f"BMP compression {compression} (RLE or bit fields at {bits} bits) "
                         "is not supported")
    if bits not in (1, 4, 8, 24, 32):
        raise ValueError(f"BMP of {bits} bits per pixel is not supported")
    stride = (W * bits + 31) // 32 * 4
    if len(data) < offset + stride * H:
        raise ValueError("truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * H, offset).reshape(H, stride)
    if not top_down:
        rows = rows[::-1]
    if bits == 24:
        return rows[:, :W * 3].reshape(H, W, 3)[..., ::-1].copy()
    if bits == 32:
        px = rows[:, :W * 4].reshape(H, W, 4)
        if masks is None:
            return px[..., 2::-1].copy()
        out = np.empty((H, W, 3), np.uint8)
        for c, m in enumerate(masks):
            if m not in (0xFF, 0xFF00, 0xFF0000, 0xFF000000):
                raise ValueError(f"BMP bit field mask {m:#x} is not supported")
            out[..., c] = px[..., {0xFF: 0, 0xFF00: 1, 0xFF0000: 2, 0xFF000000: 3}[m]]
        return out
    n = colors or (1 << bits)
    pal_at = 14 + hsize
    pal = np.frombuffer(data, np.uint8, n * entry, pal_at).reshape(n, entry)[:, 2::-1]
    lut = np.zeros((256, 3), np.uint8)
    lut[:min(n, 256)] = pal[:256]
    idx = _png_samples(rows, W, bits, 1)[..., 0]
    return lut[idx]


def _tiff_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of a TIFF-format EXIF block's first IFD,
    read as OpenCV's ``ExifReader`` reads it (the value's first 16 bits,
    whatever its type); 1 where the block has none or cannot be read."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    if struct.unpack(e + "H", tiff[2:4])[0] != 42:
        return 1
    (ifd,) = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (n,) = struct.unpack(e + "H", tiff[ifd:ifd + 2])
    for at in range(ifd + 2, min(ifd + 2 + 12 * n, len(tiff) - 11), 12):
        if struct.unpack(e + "H", tiff[at:at + 2])[0] == 0x0112:
            return struct.unpack(e + "H", tiff[at + 8:at + 10])[0]
    return 1


def exif_orientation(data: bytes) -> int:
    """The EXIF orientation (1-8; 1 is upright) that ``cv2.imread`` applies:
    from a JPEG's first APP1 segment (past its 6-byte ``Exif\\0\\0`` header,
    which OpenCV does not check), a PNG's ``eXIf`` chunk before the image
    data or a WebP's ``EXIF`` chunk (a TIFF block from its first byte); 1 for
    any other file."""
    if data[:3] == b"\xff\xd8\xff":
        pos = 2
        while pos + 4 <= len(data) and data[pos] == 0xFF:
            marker = data[pos + 1]
            if marker in (0xD9, 0xDA):  # EOI, SOS: no APP1 before the scan
                break
            (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
            if marker == 0xE1:
                return _tiff_orientation(data[pos + 4 + 6:pos + 2 + n])
            pos += 2 + n
    elif data[:8] == PNG_SIGNATURE:
        pos = 8
        while pos + 8 <= len(data):
            (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
            if kind == b"eXIf":
                return _tiff_orientation(data[pos + 8:pos + 8 + n])
            if kind in (b"IDAT", b"IEND"):
                break
            pos += 12 + n
    elif data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        pos = 12
        while pos + 8 <= len(data):
            (n,), kind = struct.unpack("<I", data[pos + 4:pos + 8]), data[pos:pos + 4]
            if kind == b"EXIF":
                return _tiff_orientation(data[pos + 8:pos + 8 + n])
            pos += 8 + n + (n & 1)
    return 1


_ORIENTED = {  # EXIF orientation -> the view OpenCV's ExifTransform makes
    2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
    5: lambda a: a.transpose(1, 0, 2), 6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
    7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1], 8: lambda a: a.transpose(1, 0, 2)[::-1]}


def read_image(path: str, imread: bool = False) -> np.ndarray:
    """uint8 [H, W, 3] of an image file, equal to
    ``np.asarray(PIL.Image.open(path).convert("RGB"))``, or with ``imread`` to
    ``cv2.imread(path)[..., ::-1]``; the format is taken from the file's
    signature. Anything not read raises ValueError naming the file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_image(data, imread)
    except (ValueError, zlib.error) as e:
        raise ValueError(f"{path}: {e}") from None


def decode_image(data: bytes, imread: bool = False) -> np.ndarray:
    """:func:`read_image` on the bytes of a file. ``imread`` differs from
    Pillow's reading in two things only: the EXIF orientation is applied
    (:func:`exif_orientation`), and 16-bit gray PNG samples keep their high
    byte where Pillow clips them at 255."""
    if data[:8] == PNG_SIGNATURE:
        img = decode_png_rgb(data, imread)
    elif data[:3] == b"\xff\xd8\xff":
        img = decode_jpeg(data)
    elif data[:2] == b"BM":
        img = decode_bmp_rgb(data)
    elif data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        img = decode_webp(data)
    else:
        raise ValueError("not a PNG, JPEG, BMP or WebP file")
    if imread and (turn := _ORIENTED.get(exif_orientation(data))):
        img = np.ascontiguousarray(turn(img))
    return img
