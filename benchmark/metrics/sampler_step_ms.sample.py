"""Milliseconds per reverse step: the spans around each p_sample_loop, which end in a sync in the traced run, over all their steps; the profiled batch's loops left out."""


def read(obs):
    n = obs["spans"].count("p_sample_loop") * obs["steps"]
    return 1e3 * obs["spans"].total("p_sample_loop") / n if n else None
