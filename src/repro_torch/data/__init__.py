"""Curve datasets for the port: the synthetic prior, artifacts, sources and
transforms (counterpart of ``repro.data``; the token pipeline is not ported
yet, ROADMAP queue 1 item 14).

* :mod:`repro_torch.data.curves`     - the synthetic LCBench-like prior and
  :class:`CurveTask`, suite stacking, scheduler observation models.
* :mod:`repro_torch.data.sources`    - :class:`CurveSource` protocol and
  registry (``get_source("synthetic:crossing")``,
  ``get_source("lcbench:<path>")``).
* :mod:`repro_torch.data.lcbench`    - LCBench/ifBO-format npz artifact IO.
* :mod:`repro_torch.data.transforms` - composable, invertible per-task
  metric / progression standardization.
"""
from .curves import (CurveTask, benchmark_cutoffs, noisy_step_fns,
                     replay_step_fns, sample_suite, sample_task, stack_suite)
from .lcbench import LCBenchArtifact, load_artifact, write_artifact
from .sources import (CurveSource, LCBenchSource, SyntheticSource,
                      get_source, list_source_kinds, register_source)
from .transforms import AffineTransform, Compose, LogWarp, metric_transform

__all__ = ["CurveTask", "sample_task", "sample_suite", "stack_suite",
           "noisy_step_fns", "replay_step_fns", "benchmark_cutoffs",
           "LCBenchArtifact", "load_artifact", "write_artifact",
           "CurveSource", "LCBenchSource", "SyntheticSource", "get_source",
           "list_source_kinds", "register_source", "AffineTransform",
           "Compose", "LogWarp", "metric_transform"]
