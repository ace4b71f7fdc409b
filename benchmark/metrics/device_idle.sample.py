"""1 - the union of the card's kernel, copy and fill intervals over the traced
slice's wall time, in %."""


def read(obs):
    t = obs["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
