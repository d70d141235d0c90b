"""``mfu``: the MVM operations the traced passes' solves needed (active
columns times 2 (n^2 m + n m^2)) over the passes' seconds at the TF32 peak.
Read only from a trace in which the device ran."""
from ..peaks import PEAK_FLOPS, mvm_flops


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    n, m = run.shape
    return 100.0 * mvm_flops(n, m, run.trace["matvecs"]) / (
        run.trace["window_s"] * PEAK_FLOPS["tf32"])
