"""The port's user tools: the two benches, the checkpoint converter, the VQGAN
roundtrip ceiling, the sampler sweep (``bench.py`` and ``scripts/`` of the JAX
package), and the demonstrations with their tools: the synthetic datasets, the
pixel, stochastic and chain demos, the TensorBoard reader, the random metric
backbones and the parity protocol. Each runs on the CUDA card unless asked for
the CPU, and each is a module with a ``main(argv=None)``:
``python -m bbdm_tpu_torch.tools.<name>``."""
