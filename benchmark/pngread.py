"""Read back an 8-bit, non-interlaced PNG (gray, RGB or RGBA) with the
standard library and numpy, for judging the files a run wrote."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def read_png(path: str) -> np.ndarray:
    """uint8 [H, W, C]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    W, H, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB/RGBA")
    C = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, 1 + W * C)
    out = np.zeros((H, W * C), np.int32)
    for y in range(H):
        ftype, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        up = out[y - 1] if y else np.zeros(W * C, np.int32)
        if ftype == 0:
            out[y] = row
        elif ftype == 2:
            out[y] = (row + up) & 255
        elif ftype in (1, 3, 4):
            cur = out[y]
            for i in range(W * C):
                a = cur[i - C] if i >= C else 0
                c = up[i - C] if i >= C else 0
                b = up[i]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (row[i] + pred) & 255
        else:
            raise ValueError(f"{path}: filter type {ftype}")
    return out.astype(np.uint8).reshape(H, W, C)
