"""The plain PyTorch reference that decides ``correct``: float32 with TF32
off, no kernel, nothing of the measured program imported."""
