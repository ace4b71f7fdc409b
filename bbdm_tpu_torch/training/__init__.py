"""Training: the optimizers, the plateau schedule, the EMA, the train state and
the train and eval steps (port of ``bbdm_tpu/training``, one process)."""
