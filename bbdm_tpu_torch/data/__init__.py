"""Data layer: the five dataset types, the image cache of ``cache_in_ram`` and
the prefetching, multi-threaded loader (port of ``bbdm_tpu/data``), reading
PNG, JPEG and BMP without Pillow."""

from bbdm_tpu_torch.data.loader import DataLoader  # noqa: F401
from bbdm_tpu_torch.data.utils import get_dataset  # noqa: F401
