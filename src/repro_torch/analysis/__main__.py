"""``python -m repro_torch.analysis`` — the port's static-analysis gate.

Default run = the AST lint rules over the given paths (default
``src/repro_torch``) + the budget audit of the kernels' routes (both
without a device). ``--audit`` adds the dispatch audits
(:mod:`repro_torch.analysis.dispatch_audit`) on ``--device`` (default: the
GPU). Exit status is 0 iff no *new* findings — nothing unsuppressed and
unbaselined — and every audit holds.

Typical invocations::

    python -m repro_torch.analysis src/repro_torch --baseline analysis_baseline_torch.json
    python -m repro_torch.analysis --audit --device cpu
    python -m repro_torch.analysis src/repro_torch --write-baseline analysis_baseline_torch.json
    python -m repro_torch.analysis path/to/file.py --format json
"""
from __future__ import annotations

import argparse
import json
import sys

from .runner import (analyze_paths, filter_baseline, format_report,
                     load_baseline, write_baseline)

PRECISIONS = ("f32", "bf16")


def budget_audit(limits=None) -> tuple[list[dict], list[str]]:
    """Every route the tuner may pick, at every precision, against the
    budget model on a device of ``limits`` (default: the H100's data
    sheet): ``(rows, failures)``. The counterpart of the reference's VMEM
    audit: its invariant is that the chooser never returns a block that
    does not fit, here that every candidate route has an instantiation of
    :mod:`repro_torch.kernels.budget` for each kernel it launches and each
    of them fits, that every precision has a route, and that every
    instantiation a launcher can pick launches on the device. A violation
    means ``kernels/autotune.py`` and ``kernels/budget.py`` drifted apart
    (or the device cannot run the kernels)."""
    from ..kernels import autotune, budget

    limits = limits or budget.H100_SXM
    rows, failures = [], []
    for prec in PRECISIONS:
        routes = autotune.candidate_routes(prec, limits)
        if not routes:
            failures.append(f"budget: no route fits {limits.name or limits} "
                            f"in {prec}")
        for route in routes:
            for name in autotune._ROUTE_BUDGETS.get((route, prec), ()):
                b = budget.INSTANTIATIONS.get(name)
                if b is None:
                    failures.append(f"budget: route {route} ({prec}) "
                                    f"launches {name!r}, which the budget "
                                    "model does not know")
                    continue
                rows.append({"route": route, "precision": prec,
                             "instantiation": name, "smem": b.smem,
                             "blocks_per_sm": b.blocks_per_sm(limits)})
    for name, b in budget.INSTANTIATIONS.items():
        if not b.fits(limits):
            failures.append(f"budget: {name} does not fit "
                            f"{limits.name or limits} ({b.smem} bytes of "
                            "shared memory)")
    return rows, failures


def _run_budget_audit(out, limits=None) -> int:
    rows, failures = budget_audit(limits)
    for msg in failures:
        print(msg, file=out)
    from ..kernels import budget
    limits = limits or budget.H100_SXM
    print(f"budget: {len(rows)} (route, precision, kernel) entries over "
          f"{len(PRECISIONS)} precisions and {len(budget.INSTANTIATIONS)} "
          f"instantiations against {limits.name or limits}: "
          f"{len(failures) or 'no'} failure(s).", file=out)
    return len(failures)


def _budget_limits(device):
    """The limits the budget is held to: a CUDA device's own (``--device``
    naming one, or none named and a GPU present), else the H100's data
    sheet."""
    import torch

    from ..kernels import budget
    if device is None and torch.cuda.is_available():
        device = "cuda"
    if device is not None and torch.device(device).type == "cuda":
        from .._device import resolve_device
        return budget.device_limits(resolve_device(device))
    return budget.H100_SXM


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="PyTorch/CUDA-aware static analysis of the port (AST "
                    "lints, the kernels' budget audit, optional dispatch "
                    "audits).")
    parser.add_argument("paths", nargs="*", default=["src/repro_torch"],
                        help="files or directories to lint (default: "
                             "src/repro_torch)")
    parser.add_argument("--baseline", metavar="FILE",
                        help="JSON baseline of grandfathered fingerprints")
    parser.add_argument("--write-baseline", metavar="FILE",
                        help="write current findings as the new baseline "
                             "and exit 0")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--audit", action="store_true",
                        help="also run the dispatch audits on --device")
    parser.add_argument("--device", default=None,
                        help="device of the audits (default: the GPU) and "
                             "of the budget's limits (default: the GPU's, "
                             "else the H100's data sheet; 'cpu': the data "
                             "sheet's)")
    parser.add_argument("--no-budget", action="store_true",
                        help="skip the kernels' budget audit")
    args = parser.parse_args(argv)

    findings = analyze_paths(args.paths or ["src/repro_torch"])

    if args.write_baseline:
        write_baseline(findings, args.write_baseline)
        print(f"wrote {len(findings)} finding(s) to {args.write_baseline}")
        return 0

    baseline: set[str] = set()
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except FileNotFoundError:
            print(f"warning: baseline {args.baseline} not found; "
                  "treating all findings as new", file=sys.stderr)
    new, baselined = filter_baseline(findings, baseline)

    failed = bool(new)
    if args.format == "json":
        print(json.dumps({"findings": [f.to_json() for f in new],
                          "baselined": baselined}, indent=2))
    else:
        print(format_report(new, baselined))

    if not args.no_budget:
        failed |= bool(_run_budget_audit(sys.stdout,
                                         _budget_limits(args.device)))

    if args.audit:
        # Imported here: the lint layer needs neither torch nor the port.
        from .._device import resolve_device
        from .dispatch_audit import run_all_audits
        failures = run_all_audits(resolve_device(args.device), verbose=True)
        failed |= bool(failures)

    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
