"""Runner utilities: the result-directory layout and file removal (port of
``bbdm_tpu/runners/utils.py:9-30``), and telling checkpoint formats apart."""

from __future__ import annotations

import os
import zipfile
from datetime import datetime


def make_dir(d: str) -> str:
    os.makedirs(d, exist_ok=True)
    return d


def remove_file(path: str) -> None:
    """Remove ``path`` if it exists."""
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def make_save_dirs(args, prefix: str, suffix: str | None = None, with_time: bool = False,
                   make: bool = True):
    """``<result_path>/<prefix>/<suffix>/{image,log,checkpoint,samples,sample_to_eval}``;
    returns (result, image, checkpoint, log, samples, sample_to_eval) paths,
    made unless ``make`` is False."""
    time_str = datetime.now().strftime("%Y-%m-%dT%H-%M-%S") if with_time else ""
    result_path = os.path.join(args.result_path, prefix, suffix or "", time_str)
    paths = (result_path, *(os.path.join(result_path, d)
                            for d in ("image", "checkpoint", "log", "samples", "sample_to_eval")))
    return tuple(make_dir(p) for p in paths) if make else paths


def is_torch_file(path: str) -> bool:
    """A ``torch.save`` file (a zip archive, or a ``.pth``/``.pt`` name) rather
    than a msgpack ``.ckpt``."""
    return path.endswith((".pth", ".pt")) or zipfile.is_zipfile(path)
