"""``idle``: the share of the traced passes' time in which no activity ran
on the device, from the profiler's timeline of the device alone."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
