"""Data parallelism: ranks, nodes and the process group (``distributed``), the
collectives and the global-batch draws (``collectives``)."""

from bbdm_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize,
    is_main,
    node_env,
    shutdown,
    world,
)
