"""Runners: ``bbdm_tpu/runners`` on PyTorch, training and sampling."""


def get_runner(name: str, config):
    """The runner registered as ``name`` (``config.runner``), built from ``config``."""
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner
    from bbdm_tpu_torch.runners.vqgan import VQGANRunner

    runners = {"BBDMRunner": BBDMRunner, "VQGANRunner": VQGANRunner}
    if name not in runners:
        raise NotImplementedError(f"runner {name!r} is not ported (ported: {sorted(runners)})")
    return runners[name](config)
