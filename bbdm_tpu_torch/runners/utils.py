"""Runner utilities: the result-directory layout (port of ``bbdm_tpu/runners/utils.py:9-30``)."""

from __future__ import annotations

import os
from datetime import datetime


def make_dir(d: str) -> str:
    os.makedirs(d, exist_ok=True)
    return d


def make_save_dirs(args, prefix: str, suffix: str | None = None, with_time: bool = False):
    """``<result_path>/<prefix>/<suffix>/{image,log,checkpoint,samples,sample_to_eval}``;
    returns (result, image, checkpoint, log, samples, sample_to_eval) paths."""
    time_str = datetime.now().strftime("%Y-%m-%dT%H-%M-%S") if with_time else ""
    result_path = make_dir(os.path.join(args.result_path, prefix, suffix or "", time_str))
    return (result_path,
            *(make_dir(os.path.join(result_path, d))
              for d in ("image", "checkpoint", "log", "samples", "sample_to_eval")))
