"""PyTorch/CUDA port of bbdm_tpu for NVIDIA Hopper (H100).

The JAX package ``bbdm_tpu`` is the reference this package is held against;
module and attribute names mirror its flax names (``unet.down_0_0.in_norm``,
``vqgan.encoder.mid_attn_1.q``, ...), activations are NCHW. On a CUDA tensor
each of the three functions the JAX package wrote in Pallas (GroupNorm, the
subpixel up-conv, flash attention) is a kernel written by hand for sm_90a;
on a CPU tensor it is the plain PyTorch twin in the same ``ops`` module.

This package imports neither jax nor flax, PyYAML nor Pillow at import time.
"""

import torch

# fp32 stages (VQGAN conv_out, quant convs, the quantizer, the UNet time MLP and
# head conv) must be real fp32 on the card; cuDNN's default is TF32.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
