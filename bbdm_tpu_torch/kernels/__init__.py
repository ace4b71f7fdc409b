"""Hand-written Hopper kernels: the nvcc build of ``csrc/*.cu`` and the Triton
GroupNorm. Nothing here imports triton or compiles anything at import time."""
