"""Output images that sample_to_eval wrote (every draw of every condition) over the whole window."""


def read(obs):
    return obs["images"] / obs["window_s"]
