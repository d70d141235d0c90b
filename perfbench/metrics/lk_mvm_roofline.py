"""``lk_mvm_roofline``: the least time the card could take for the MVM work
the traced passes' solves needed (active columns; operations at the TF32
peak or bytes at HBM's, whichever is larger) over the MVM kernels' device
time in the profiler's trace of those passes (K1, K2a, K2b)."""
from ..peaks import least_seconds, mvm_bytes, mvm_flops
from ..program import MVM_KERNELS


def read(run):
    if run.trace is None:
        return None
    dev_s = sum(s for name, s in run.trace["kernels"].items()
                if any(k in name for k in MVM_KERNELS))
    if dev_s <= 0:
        return None
    n, m = run.shape
    need = least_seconds(mvm_flops(n, m, run.trace["matvecs"]),
                         mvm_bytes(n, m, run.trace["sweeps"],
                                   run.trace["matvecs"]))
    return 100.0 * need / dev_s
