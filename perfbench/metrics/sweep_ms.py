"""``sweep_ms``: window milliseconds over the window's MVM sweeps: what one
CG iteration costs end to end, host and device together. The window runs
with no profiler, in a traced run as in any other."""


def read(run):
    return 1e3 * run.window_s / run.sweeps if run.sweeps else None
