"""What both entries share: the runner built from the configuration with the
benchmark's weights, the profiler over the traced slice, the release of the
program's state before the reference runs."""

from __future__ import annotations

import copy
import gc

import torch

from benchmark.reference import model as R
from benchmark.trace import SLICE, reduce_profile
from benchmark.weights import make_weights

WEIGHT_STREAM = 0x57454947


def weight_seed(seed: int) -> int:
    return (WEIGHT_STREAM << 32) + (seed % (1 << 32))


def build_runner(config: dict, traffic: dict, seed: int, device):
    """A ``BBDMRunner`` of the configuration as the cell runs it (its test
    batch, draws and accumulation from the traffic), holding the benchmark's
    weights for ``seed``. Returns (runner, config dict as run, param specs)."""
    from bbdm_tpu_torch.config import dict2namespace
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    cfg = copy.deepcopy({k: v for k, v in config.items() if k not in ("source", "assumed")})
    cfg["data"]["test"]["batch_size"] = traffic["batch"]
    cfg["data"]["train"]["batch_size"] = traffic["batch"]
    cfg["testing"]["sample_num"] = traffic.get("sample_num", 1)
    cfg["training"]["accumulate_grad_batches"] = traffic.get("accumulate", 1)
    runner = BBDMRunner(dict2namespace(cfg), device=device, seed=seed % (1 << 63))
    specs = R.param_specs(cfg["model"])
    weights = make_weights(specs, weight_seed(seed), device)
    runner.model.load_state_dict(weights, strict=True)
    del weights
    return runner, cfg, specs


def reference_weights(specs, seed: int, device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return R.Params(make_weights(specs, weight_seed(seed), device))


class Profiler:
    """``torch.profiler`` over the slice, with its ``bench.slice`` annotation;
    its events are read (:meth:`reduce`) once the window has closed."""

    def __init__(self, device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.ann = torch.profiler.record_function(SLICE)

    def start(self):
        self.prof.start()
        self.ann.__enter__()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.ann.__exit__(None, None, None)
        self.prof.stop()

    def reduce(self) -> dict:
        return reduce_profile(self.prof)


def release():
    """Free what the program left once its state is dropped, so that the
    reference finds the card empty."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
