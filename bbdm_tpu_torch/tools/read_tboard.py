"""TensorBoard event-file reader, the inverse of ``utils/tboard.py`` (port of
``scripts/read_tboard.py``): the TFRecord framing and the Event/Summary
protobuf wire format parsed by hand (the message subset the writers emit),
scalars only, no tensorboard import.

    python -m bbdm_tpu_torch.tools.read_tboard <logdir-or-event-file> [tag_prefix] [--cpu]
        -> CSV lines: tag,step,wall_time,value

A directory is walked for files whose name holds ``tfevents``, in sorted
order. It reads the files of both packages' writers. The reading runs on the
host; as every entry point of the port, the command takes the CUDA card and
raises where there is none, unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import struct


def _read_varint(buf: bytes, i: int):
    shift, n = 0, 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            v, i = _read_varint(buf, i)
        elif wt == 1:  # 64-bit
            v, i = buf[i:i + 8], i + 8
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        elif wt == 5:  # 32-bit
            v, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _parse_summary_value(buf: bytes):
    tag, simple_value = None, None
    for field, wt, v in _fields(buf):
        if field == 1 and wt == 2:  # tag
            tag = v.decode("utf-8", "replace")
        elif field == 2 and wt == 5:  # simple_value
            simple_value = struct.unpack("<f", v)[0]
    return tag, simple_value


def parse_event(buf: bytes):
    """-> (wall_time, step, [(tag, value), ...]) for scalar events."""
    wall_time, step, scalars = 0.0, 0, []
    for field, wt, v in _fields(buf):
        if field == 1 and wt == 1:  # wall_time double
            wall_time = struct.unpack("<d", v)[0]
        elif field == 2 and wt == 0:  # step
            step = v
        elif field == 5 and wt == 2:  # summary
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 2:  # Summary.value
                    tag, sv = _parse_summary_value(v2)
                    if tag is not None and sv is not None:
                        scalars.append((tag, sv))
    return wall_time, step, scalars


def read_events(path: str):
    """Yield (tag, step, wall_time, value) from one event file; a record cut
    short at the end of the file ends it."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            f.read(4)  # length crc
            data = f.read(length)
            f.read(4)  # data crc
            if len(data) < length:
                return
            wall_time, step, scalars = parse_event(data)
            for tag, value in scalars:
                yield tag, step, wall_time, value


def read_dir(logdir: str):
    files = []
    if os.path.isfile(logdir):
        files = [logdir]
    else:
        for root, _, names in os.walk(logdir):
            files += [os.path.join(root, n) for n in names if "tfevents" in n]
    for p in sorted(files):
        yield from read_events(p)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", help="a log directory or one event file")
    ap.add_argument("prefix", nargs="?", default="", help="keep the tags that start so")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Print the CSV; returns the rows (tag, step, wall_time, value) printed."""
    from bbdm_tpu_torch.models.factory import resolve_device

    args = parse_args(argv)
    resolve_device("cpu" if args.cpu else "cuda")
    print("tag,step,wall_time,value")
    rows = []
    for tag, step, wall_time, value in read_dir(args.path):
        if tag.startswith(args.prefix):
            print(f"{tag},{step},{wall_time:.3f},{value:.6f}")
            rows.append((tag, step, wall_time, value))
    return rows


if __name__ == "__main__":
    main()
