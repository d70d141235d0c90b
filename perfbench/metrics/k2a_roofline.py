"""``k2a_roofline``: the least time the card could take for the stage-R work
the traced passes' solves needed (``perfbench/stage_r.py``: active columns,
operations at the TF32 peak or bytes at HBM's, whichever is larger) over the
device time of K2a's kernels (names holding ``stage_right_kernel``) in the
profiler's trace of those passes. Nothing to read where K2a did not run."""
from ..stage_r import KERNEL, stage_r_seconds


def read(run):
    if run.trace is None:
        return None
    dev_s = sum(s for name, s in run.trace["kernels"].items()
                if KERNEL in name)
    if dev_s <= 0:
        return None
    n, m = run.shape
    return 100.0 * stage_r_seconds(n, m, run.trace["sweeps"],
                                   run.trace["matvecs"]) / dev_s
