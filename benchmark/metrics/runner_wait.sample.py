"""Share of the window outside the benchmark's spans around BBDMRunner.sample_batch (the loader, the writer's backlog, host copies), the profiled batch left out of both."""


def read(obs):
    return 100.0 * (1.0 - obs["spans"].total("sample_batch") / obs["untraced_s"])
