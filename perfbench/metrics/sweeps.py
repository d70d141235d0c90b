"""``sweeps``: MVM sweeps a request, from the kernel wrappers' launch counts
(one launch of K1, or of K2b after K2a, a sweep) over the window."""


def read(run):
    return run.sweeps / run.completed if run.completed else None
