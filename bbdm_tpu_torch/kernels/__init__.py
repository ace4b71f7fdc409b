"""Hand-written Hopper kernels: the nvcc build of ``csrc/*.cu``. Nothing here
compiles anything at import time."""
