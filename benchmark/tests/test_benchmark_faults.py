"""A run with the timed path broken underneath must come out not correct,
with each cell's own limits: the harness's look for a card is skipped and the
rest of the run is driven on the CPU, the tiny configuration in float32 (so
that a sound run reads round-off only and must pass)."""

import os
import time

import pytest
import torch

from benchmark import harness, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the sample cells, and one of them with several draws a condition
SAMPLE_CASES = [("lbbdm_f16.sample.b8n1", 1), ("lbbdm_f4.sample.b32n1", 1),
                ("lbbdm_f4.sample.b32n1", 3)]


def _cell(tiny, name, **traffic):
    cell = harness.Cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), name, ROOT)
    cell.config = tiny
    cell.traffic = dict(cell.traffic, batch=4, pool=24, check_update_from=1,
                        check_update_span=2, **traffic)
    return cell


def _correct(cell):
    line, checks = run.run(cell, 2 ** 31 + 101, 0.5, 0, torch.device("cpu"),
                           t_start=time.perf_counter())
    return line["correct"], checks


def _unchanged_loop(self, y, *a, **kw):
    return y


def _half_loop(original):
    def loop(self, y, context=None, *, noise=None, **kw):
        h = y.shape[0] // 2
        part = original(self, y[:h], None, noise=[n[:h] for n in noise], **kw)
        return torch.cat([part, part])
    return loop


def _altered_decode(original):
    def decode(self, z, **kw):
        return original(self, z, **kw) + 0.1
    return decode


@pytest.mark.parametrize("name,draws", SAMPLE_CASES)
def test_sound_sampling_run_is_correct(tiny, name, draws):
    correct, checks = _correct(_cell(tiny, name, sample_num=draws))
    assert correct, checks


@pytest.mark.parametrize("fault", ["unchanged_step", "half_batch", "altered_answer"])
@pytest.mark.parametrize("name,draws", SAMPLE_CASES)
def test_broken_sampling_is_not_correct(tiny, name, draws, fault, monkeypatch):
    from bbdm_tpu_torch.models.bridge import BrownianBridgeModel
    from bbdm_tpu_torch.models.latent import LatentBrownianBridgeModel

    if fault == "unchanged_step":
        monkeypatch.setattr(BrownianBridgeModel, "p_sample_loop", _unchanged_loop)
    elif fault == "half_batch":
        monkeypatch.setattr(BrownianBridgeModel, "p_sample_loop",
                            _half_loop(BrownianBridgeModel.p_sample_loop))
    else:
        monkeypatch.setattr(LatentBrownianBridgeModel, "decode",
                            _altered_decode(LatentBrownianBridgeModel.decode))
    correct, checks = _correct(_cell(tiny, name, sample_num=draws))
    assert not correct, checks


def test_sound_training_run_is_correct(tiny):
    correct, checks = _correct(_cell(tiny, "lbbdm_f4.train.b8a4"))
    assert correct, checks


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "late_unchanged_state",
                                   "late_doubled_step"])
def test_broken_training_is_not_correct(tiny, fault, monkeypatch):
    """The late faults start after set-up's compared updates: only the
    checked window update can see them."""
    from bbdm_tpu_torch.models.latent import LatentBrownianBridgeModel
    from bbdm_tpu_torch.training.optim import Optimizer

    update = Optimizer.update

    def late(fn):
        def patched(self, grads, lr):
            return (update if int(self.state["count"]) < 3 else fn)(self, grads, lr)
        return patched

    if fault == "unchanged_state":
        monkeypatch.setattr(Optimizer, "update", lambda self, grads, lr: None)
    elif fault == "late_unchanged_state":
        monkeypatch.setattr(Optimizer, "update", late(lambda self, grads, lr: None))
    elif fault == "late_doubled_step":
        monkeypatch.setattr(Optimizer, "update", late(lambda self, grads, lr: update(
            self, grads, 2 * lr)))
    else:
        loss = LatentBrownianBridgeModel.loss

        def half(self, x, y, context=None, *, t=None, noise=None, **kw):
            h = x.shape[0] // 2
            return loss(self, x[:h], y[:h], context, t=t[:h], noise=noise[:h], **kw)
        monkeypatch.setattr(LatentBrownianBridgeModel, "loss", half)
    correct, checks = _correct(_cell(tiny, "lbbdm_f4.train.b8a4"))
    assert not correct, checks
