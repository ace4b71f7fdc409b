"""torch.cuda.max_memory_allocated over the window, reset at its start, in GiB."""


def read(obs):
    return obs["peak_bytes"] / 2 ** 30
