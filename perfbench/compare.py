"""The comparison that decides ``correct``: the program's answers against the
plain reference's on the same inputs.

For one request the reference (``perfbench/reference/lkgp.py``, float64)
works out the final-epoch mean and Matheron variance of every configuration
from the raw inputs, solving to ``TRUTH_TOL``, far below the configuration's
``cg_tol``. Three numbers are compared, each against its limit in
``perfbench/limits/<cell>.json``:

* ``resid_y``: the program's solve ``alpha = K^{-1} y``, put back into the
  reference's float64 operator: ``||y - K alpha|| / ||y||``. The
  configuration states its limit, ``cg_tol``.
* ``mean_vs_solve``: the widest gap between the program's final means and
  the means the reference's float64 products make of the program's own
  solve, ``K1 alpha K2``, over the observed standard deviation of y. With
  ``resid_y`` it holds the means as close to the truth as the tolerance
  lets a solve be.
* ``var_gap``: the widest gap between the program's final variances and the
  reference's (the same standard normals, the solve to ``TRUTH_TOL``), over
  the reference's median variance: a guard against gross errors (a lost
  noise term, a wrong scale).
* ``var_scatter``: the standard deviation over configurations of the
  program's variance over the reference's, less one. The tolerance of the
  solve shifts every configuration's variance alike; draws that go missing
  scatter them, which this number sees where ``var_gap`` cannot.
"""
from __future__ import annotations

import torch

from .reference.lkgp import final_mean, posterior_final, relative_residual

__all__ = ["TRUTH_TOL", "reference_answer", "gaps", "within"]

# The reference's own solve: 1e-6 of ||b||, four orders below cg_tol.
TRUTH_TOL = 1e-6


def reference_answer(inputs: dict, config: dict, precision: str = "float64",
                     tol: float = TRUTH_TOL):
    """The reference's answer for one request's inputs (``X, t, Y, mask``,
    ``normals``; the configuration's hyper-parameters and jitter)."""
    return posterior_final(inputs["X"], inputs["t"], inputs["Y"],
                           inputs["mask"], inputs["theta"], inputs["normals"],
                           jitter=config["lkgp"]["jitter"], tol=tol,
                           precision=precision)


def gaps(answer, ref) -> dict:
    """The compared numbers of one answer (``mean``, ``var``, ``alpha``)
    against the reference's answer ``ref`` to the same request."""
    def f64(x):
        return torch.as_tensor(x, dtype=torch.float64, device=ref.mean.device)

    mean, var, alpha = f64(answer["mean"]), f64(answer["var"]), \
        f64(answer["alpha"])
    scale = float(ref.transforms.y_scale)
    out = {
        "resid_y": float(relative_residual(ref.operator, alpha,
                                           ref.rhs).max()),
        "mean_vs_solve": float((mean - final_mean(ref.K1, alpha, ref.K2,
                                                  ref.transforms)).abs().max())
        / scale,
        "var_gap": float((var - ref.var).abs().max() / ref.var.median()),
        "var_scatter": float((var / ref.var - 1.0).std()),
    }
    for k, v in out.items():
        if v != v:   # NaN compares as nothing: count it as the worst reading
            out[k] = float("inf")
    return out


def within(readings: dict, limits: dict) -> bool:
    """Every compared number at or below its limit."""
    return all(readings[k] <= limits[k] for k in limits)
