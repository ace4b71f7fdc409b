"""Runners: the sampling side of ``bbdm_tpu/runners``."""


def get_runner(name: str, config):
    """The runner registered as ``name`` (``config.runner``), built from ``config``."""
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    runners = {"BBDMRunner": BBDMRunner}
    if name not in runners:
        raise NotImplementedError(f"runner {name!r} is not ported (ported: {sorted(runners)}; "
                                  "VQGAN training is ROADMAP.md §1 item 6)")
    return runners[name](config)
