"""What the three demonstration tools (``pixel_demo``, ``stochastic_demo``,
``chain_demo``) share, as each of the JAX scripts carries it: the CLI namespace
for the runner, the resumable per-phase JSON reports, the deadline, the
resume of a training phase from its last checkpoint, and the rule that an
external stop writes no report."""

from __future__ import annotations

import argparse
import json
import os
import time


def make_args(result_path, cpu: bool, seed: int = 1234, **kw):
    """The CLI namespace of ``main_torch.py --train`` (override with ``kw``) on
    card 0, or the CPU with ``cpu``."""
    d = dict(train=True, sample_to_eval=False, sample_at_start=False, save_top=False,
             seed=seed, result_path=str(result_path), resume_model=None, resume_optim=None,
             max_epoch=None, max_steps=None, gpu_ids="-1" if cpu else "0", port="12355",
             config="")
    d.update(kw)
    return argparse.Namespace(**d)


class Reports:
    """``<result>/report_<phase>.json``: a phase whose report exists is done."""

    def __init__(self, result_dir: str, tag: str):
        self.result_dir, self.tag = result_dir, tag

    def path(self, phase: str) -> str:
        return os.path.join(self.result_dir, f"report_{phase}.json")

    def exists(self, phase: str) -> bool:
        return os.path.exists(self.path(phase))

    def read(self, phase: str) -> dict:
        with open(self.path(phase)) as f:
            return json.load(f)

    def write(self, phase: str, payload: dict) -> dict:
        os.makedirs(self.result_dir, exist_ok=True)
        with open(self.path(phase), "w") as f:
            json.dump(payload, f, indent=1, default=float)
        print(f"[{self.tag}:{phase}] " + json.dumps(payload, default=float), flush=True)
        return payload


def past_deadline(deadline_ts, tag: str, what: str) -> bool:
    """True (with a line saying so) once the unix time ``deadline_ts`` has passed:
    ``what`` is not started, and rerunning the command resumes there."""
    if deadline_ts is not None and time.time() > deadline_ts:
        print(f"[{tag}] deadline passed, skipping {what} (resumable: re-run the same "
              "command later)", flush=True)
        return True
    return False


def resume_paths(result_dir: str, dataset_name: str, model_name: str, tag: str) -> dict:
    """``resume_model``/``resume_optim`` of a training phase that died before
    its report but after its runner wrote ``last_model``/``last_optim_sche``
    (the periodic, graceful-stop or exception save), else {}."""
    ck = os.path.join(result_dir, dataset_name, model_name, "checkpoint")
    model = os.path.join(ck, "last_model.ckpt")
    optim = os.path.join(ck, "last_optim_sche.ckpt")
    if os.path.exists(model) and os.path.exists(optim):
        print(f"[{tag}] resuming training from {model}", flush=True)
        return {"resume_model": model, "resume_optim": optim}
    return {}


def interrupted(runner, tag: str, phase: str) -> bool:
    """True when an external graceful stop (SIGTERM, the stop file) cut the
    phase's training short (``runner.stop_reason``): the phase is not done and
    writes no report, so the next invocation resumes it. A wall budget
    (``training.max_wall_sec``) is a time box and counts as done."""
    stop = runner.stop_reason
    if stop is None or stop.startswith("wall budget"):
        return False
    print(f"[{tag}] phase {phase} interrupted ({stop}); exiting without a report - re-run "
          "the same command to resume", flush=True)
    return True
