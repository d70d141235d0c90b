"""What the benchmark takes from the program under test, ``repro_torch``:
its entry points, its counters and its kernels' names. Nothing else of the
benchmark imports the program, and the reference imports none of it.

The program lives in ``src/`` of the checkout; :func:`load` puts that on the
path and imports it, so a checkout without it fails here, before any run.
"""
from __future__ import annotations

import sys
from pathlib import Path

__all__ = ["load", "launches", "sweeps", "escalations", "routes",
           "MVM_KERNELS"]

ROOT = Path(__file__).resolve().parents[1]

# Substrings of the device kernels' names that make one MVM sweep: the
# tensor-core body (K1 fused, K2b stage L) and K2a's streaming stage R.
MVM_KERNELS = ("lk_mvm_tc_kernel", "stage_right_kernel")


def load():
    """Import the program's modules the clients call; returns them as a
    namespace-like module (``repro_torch``)."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch  # noqa: F401
    import repro_torch.autotune  # noqa: F401
    import repro_torch.core  # noqa: F401
    import repro_torch.kernels.autotune  # noqa: F401
    import repro_torch.kernels.lk_mvm  # noqa: F401
    return repro_torch


def _wrappers():
    from repro_torch.kernels import lk_mvm
    return {"K1": lk_mvm.lk_mvm_fused, "K2a": lk_mvm.lk_mvm_stage_right,
            "K2b": lk_mvm.lk_mvm_stage_left}


def launches() -> dict:
    """Each MVM wrapper's launch count so far in this process."""
    return {k: int(w.launches) for k, w in _wrappers().items()}


def sweeps(before: dict, after: dict) -> int:
    """MVM sweeps between two launch counts: one launch of K1, or one of
    K2b after one of K2a, a sweep."""
    return (after["K1"] - before["K1"]) + (after["K2b"] - before["K2b"])


def escalations() -> dict:
    from repro_torch.core import escalation_tally
    return dict(escalation_tally())


def routes() -> list:
    """The route the tuner chose for each (n, m, B) bucket it resolved."""
    from repro_torch.kernels.autotune import cache_contents
    return [{"bucket_B_n_m": [k[2], k[0], k[1]], "precision": k[3],
             "route": c.route, "mode": c.mode,
             "times_ms": {r: round(v, 4) for r, v in c.times_ms.items()}}
            for k, c in cache_contents().items()]
