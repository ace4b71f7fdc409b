"""TensorBoard event writer in pure Python: scalars and images
(the port's copy of ``bbdm_tpu/utils/tboard.py``, with PNGs from ``utils/images``).

Writes TFRecord event files: hand-encoded Event/Summary protobuf messages,
each record framed with masked CRC32C checksums.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

import numpy as np

from bbdm_tpu_torch.utils.images import encode_png


def _make_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for n in range(256):
        crc = n
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _make_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _string(field: int, s: bytes) -> bytes:
    return _key(field, 2) + _varint(len(s)) + s


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _event(step: int | None, summary: bytes | None, file_version: str | None = None) -> bytes:
    msg = _double(1, time.time())
    if step is not None:
        msg += _int64(2, step)
    if file_version is not None:
        msg += _string(3, file_version.encode())
    if summary is not None:
        msg += _string(5, summary)
    return msg


class SummaryWriter:
    """The scalar and image subset of torch's ``SummaryWriter``; the file is
    ``events.out.tfevents.<time>.<host>.<pid>`` in ``log_dir``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}"
        self._path = os.path.join(log_dir, fname)
        self._file = open(self._path, "ab")
        self._lock = threading.Lock()
        self._write_record(_event(None, None, file_version="brain.Event:2"))

    def _write_record(self, data: bytes):
        hdr = struct.pack("<Q", len(data))
        with self._lock:
            self._file.write(hdr)
            self._file.write(struct.pack("<I", _masked_crc(hdr)))
            self._file.write(data)
            self._file.write(struct.pack("<I", _masked_crc(data)))
            self._file.flush()

    def add_scalar(self, tag: str, value, step: int):
        value_msg = _string(1, tag.encode()) + _float(2, float(value))
        self._write_record(_event(int(step), _string(1, value_msg)))

    def add_image(self, tag: str, img, step: int, dataformats: str = "HWC"):
        """img: uint8 array, HWC (or HW for grayscale)."""
        img = np.asarray(img)
        if dataformats == "CHW":
            img = np.transpose(img, (1, 2, 0))
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        h, w = img.shape[:2]
        c = 1 if img.ndim == 2 else img.shape[2]
        image_msg = _int64(1, h) + _int64(2, w) + _int64(3, c) + _string(4, encode_png(img))
        value_msg = _string(1, tag.encode()) + _string(4, image_msg)
        self._write_record(_event(int(step), _string(1, value_msg)))

    def flush(self):
        with self._lock:
            self._file.flush()

    def close(self):
        with self._lock:
            self._file.close()
