"""Spans: named intervals of the program's host time, kept in memory.

``with span("sampler.step"): ...`` records one :class:`Record`: its name,
its start and end on ``time.perf_counter_ns()`` (the clock the benchmark's
own spans read), the index of the span that encloses it on the same thread
(``None`` for a root), and the thread. Every span below a root thus carries
the root's index through its parents: one sampling draw (``sampler.loop``)
or one microbatch (``train.step``).

The records go into one ring of :data:`CAPACITY` per process, which drops
the oldest when full; :func:`records` returns what it holds, :func:`clear`
empties it. Nothing is written to disk. While a ``torch.profiler`` session
collects, each span is also a ``torch.profiler.record_function`` of its
name, so it shows in the profiler's trace (``training.profile_dir``) on the
profiler's clock. Without one a span costs two clock reads and an append:
it never synchronises the card, reads a tensor or allocates on the device.

The program's spans (each in the module named):

* ``sampler.loop`` (``models/bridge.py``): one ``p_sample_loop`` call;
* ``sampler.step``: one reverse step of it, its UNet forwards included;
* ``sampler.capture``: the capture of a reverse step as a CUDA graph (its
  warm-up run included), inside the loop that first needs it;
* ``sampler.replay``: the launch of the captured step, the child of a
  ``sampler.step`` that replays it (that step then holds no
  ``unet.forward``: the UNet runs inside the graph);
* ``unet.forward`` (``models/unet.py``): one ``UNet.forward``;
* ``unet.transformer`` (``models/layers.py``): one ``SpatialTransformer``
  forward, a child of ``unet.forward``; like it, seen where the UNet runs
  eagerly (training, a step's capture, the CPU), not inside a replay;
* ``runner.writer_wait`` (``runners/bbdm.py``): ``sample_to_eval`` waiting
  on its PNG writer's backlog;
* ``train.step`` (``training/step.py``): one microbatch's ``train_step``;
* ``train.forward``, ``train.backward``: its loss and the loss's backward;
* ``train.update``: on an update microbatch, the optimizer, the plateau,
  the gradients' clearing and the EMA.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 65536


class Record(NamedTuple):
    index: int
    name: str
    start: int  # ns, time.perf_counter_ns()
    end: int
    parent: Optional[int]  # the enclosing span's index on this thread; None for a root
    thread: int  # threading.get_ident()


class _Stack(threading.local):
    def __init__(self):
        self.open = []  # indices of this thread's open spans, innermost last


_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_index = itertools.count()
_stack = _Stack()


class span:
    """Context manager recording one span named ``name``."""

    __slots__ = ("name", "index", "parent", "start", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        open_ = _stack.open
        self.parent = open_[-1] if open_ else None
        self.index = next(_index)
        open_.append(self.index)
        self.annotation = None
        if _autograd_profiler._is_profiler_enabled:
            # read the clock right after the profiler has read its own (and before
            # it reads it at the end), so that the record and the annotation differ
            # by as little as can be and the profiler's bookkeeping falls outside
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _stack.open.pop()
        _ring.append(Record(self.index, self.name, self.start, end, self.parent,
                            threading.get_ident()))
        return False


def records() -> list:
    """The ring's records, oldest first, in the order the spans closed."""
    return list(_ring)


def clear() -> None:
    _ring.clear()
