"""Seconds from the run script's first statement to the window's start."""


def read(obs):
    return obs["setup_s"]
