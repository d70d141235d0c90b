"""``setup_s``: seconds from the launch of the process to the start of the
window (imports, inputs, the program's state, builds, the tuner, warm-up)."""


def read(run):
    return run.setup_s
