"""Share of the window that ``sample_to_eval`` spent waiting on its PNG
writer's backlog (the program's ``runner.writer_wait`` spans,
``runners/bbdm.py``), the profiled batch left out of both."""

from benchmark.program_spans import share


def read(obs):
    return share(obs, "runner.writer_wait")
