"""Data layer: the ``custom_single`` and ``custom_aligned`` datasets and the
prefetching loader (port of ``bbdm_tpu/data``), reading PNG without Pillow."""

from bbdm_tpu_torch.data.loader import DataLoader  # noqa: F401
from bbdm_tpu_torch.data.utils import get_dataset  # noqa: F401
