"""Training images consumed (microbatches x batch) over the whole window, every optimizer, plateau and EMA update in it included."""


def read(obs):
    return obs["images"] / obs["window_s"]
