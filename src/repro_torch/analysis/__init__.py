"""repro_torch.analysis — static and dispatch analysis of the port.

Counterpart of ``repro.analysis``. Three layers (see each module's
docstring):

* :mod:`repro_torch.analysis.rules` + :mod:`repro_torch.analysis.runner` —
  stdlib-AST lint rules (RT101..RT106) for PyTorch-on-CUDA footguns:
  generator seed reuse, Python control flow on tensors in loops, host
  syncs in solver loops, implicit float64, mutable defaults, banned
  imports (jax / repro; triton at module level).
* :mod:`repro_torch.analysis.dispatch_audit` — audits of what the port's
  paths dispatch (every aten op's output dtypes, every host read), the
  counterpart of ``jaxpr_audit``.
* the budget audit of ``python -m repro_torch.analysis`` — every route the
  tuner may pick fits the device by :mod:`repro_torch.kernels.budget`, the
  counterpart of the reference's VMEM audit.

CLI: ``python -m repro_torch.analysis src/repro_torch --baseline
analysis_baseline_torch.json``. ``rules`` and ``runner`` are pure stdlib;
``dispatch_audit`` imports torch and the port and is opt-in via
``--audit``.
"""
from .rules import ALL_RULES, RULES_BY_ID, Finding
from .runner import (analyze_file, analyze_paths, analyze_source,
                     filter_baseline, format_report, load_baseline,
                     write_baseline)

__all__ = [
    "ALL_RULES", "RULES_BY_ID", "Finding",
    "analyze_source", "analyze_file", "analyze_paths",
    "load_baseline", "write_baseline", "filter_baseline", "format_report",
]
