"""The port's user tools: the two benches, the checkpoint converter, the VQGAN
roundtrip ceiling and the sampler sweep (``bench.py`` and ``scripts/`` of the
JAX package). Each runs on the CUDA card unless asked for the CPU, and each is
a module with a ``main(argv=None)``: ``python -m bbdm_tpu_torch.tools.<name>``."""
