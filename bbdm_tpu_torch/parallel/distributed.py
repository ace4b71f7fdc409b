"""Ranks and nodes of a data-parallel run (the port's counterpart of
``bbdm_tpu/parallel/distributed.py`` and of the mesh's ``data`` axis).

The port runs one process per card, a *rank*. The ranks that one
``main_torch.py`` invocation starts (one per ``--gpu_ids`` entry) form a
*node*, the counterpart of one JAX process with its local devices. Ranks are
numbered node by node: ``rank = node * local_size + local_rank``.

Several nodes take the JAX package's variables, with a node where JAX has a
process:

    BBDM_MULTIHOST=1             this invocation is one node of several
    BBDM_COORDINATOR=host:port   the rendezvous (default 127.0.0.1:--port)
    BBDM_NUM_PROCESSES=N         the number of nodes (default 1)
    BBDM_PROCESS_ID=i            this node's index (default 0)

Card ranks talk over NCCL, CPU ranks over gloo; :func:`initialize` takes
``backend="gloo"`` for ranks that share one card (NCCL refuses two ranks on
one device). Barriers and the stop flag go over a gloo group on the host
whatever the backend.

The process group is process-wide state, as ``torch.distributed``'s is:
:func:`initialize` sets it, :func:`shutdown` clears it, and :func:`world`
reads it (one rank of one node when nothing was initialized).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class World:
    rank: int = 0
    size: int = 1
    local_rank: int = 0  # this rank's index in its node
    local_size: int = 1  # ranks per node
    backend: Optional[str] = None

    @property
    def node(self) -> int:
        return self.rank // self.local_size

    @property
    def nodes(self) -> int:
        return self.size // self.local_size


_world = World()
_host_group = None  # gloo group for barriers and host flags


def world() -> World:
    return _world


def is_main() -> bool:
    """Rank 0: the one rank that logs and writes the run's files."""
    return _world.rank == 0


def host_group():
    return _host_group


def node_env(port) -> tuple:
    """(nodes, node, coordinator "host:port") from the ``BBDM_*`` variables:
    (1, 0, "127.0.0.1:<port>") without ``BBDM_MULTIHOST=1``."""
    default = f"127.0.0.1:{port}"
    if os.environ.get("BBDM_MULTIHOST") != "1":
        return 1, 0, default
    nodes = int(os.environ.get("BBDM_NUM_PROCESSES", "1"))
    node = int(os.environ.get("BBDM_PROCESS_ID", "0"))
    if not 0 <= node < nodes:
        raise ValueError(f"BBDM_PROCESS_ID={node} is not one of {nodes} nodes")
    return nodes, node, os.environ.get("BBDM_COORDINATOR") or default


def initialize(rank: int, size: int, *, init_method: str, local_size: int = 1,
               backend: Optional[str] = None, device=None) -> World:
    """Join the process group as ``rank`` of ``size`` (``local_size`` ranks per
    node) at ``init_method`` (``tcp://host:port``). ``backend`` None picks NCCL
    for a CUDA ``device`` (made this process's current card) and gloo for the
    CPU."""
    global _world, _host_group
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    if size % local_size:
        raise ValueError(f"{size} ranks do not make nodes of {local_size}")
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size)
    _host_group = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    _world = World(rank, size, rank % local_size, local_size, backend)
    return _world


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    global _world, _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _world, _host_group = World(), None
