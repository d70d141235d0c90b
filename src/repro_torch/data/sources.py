"""Pluggable curve-dataset sources behind one registry.

Counterpart of ``repro.data.sources`` (a copy: the port imports nothing of
the reference).

A :class:`CurveSource` yields :class:`~repro_torch.data.curves.CurveTask` suites
from *somewhere* — the synthetic prior, an LCBench/ifBO-format artifact on
disk — behind one spec string, so benchmarks and schedulers are agnostic
to where curves come from:

    get_source("synthetic:crossing")                 # prior, crossing regime
    get_source("lcbench:tests/fixtures/lcbench_mini.npz")
    get_source("ifbo:path/to/artifact.npz")          # same loader

The part before the first ``:`` selects the registered source kind; the
remainder is the kind-specific argument (a synthetic variant name, an
artifact path). ``source.dataset_id`` is the stable tag benchmark rows
carry so the regression gate never compares synthetic and real rows
against each other.
"""
from __future__ import annotations

import os
from typing import Protocol, runtime_checkable

from .curves import CurveTask, sample_suite
from .lcbench import LCBenchArtifact, load_artifact

__all__ = ["CurveSource", "SOURCES", "register_source", "get_source",
           "list_source_kinds", "SyntheticSource", "LCBenchSource"]


@runtime_checkable
class CurveSource(Protocol):
    """A provider of curve-prediction tasks."""

    spec: str           # the full spec this source was built from
    dataset_id: str     # stable tag for benchmark rows / regression gating
    maximize: bool      # metric convention of the yielded tasks

    def tasks(self, num_tasks: int | None = None, seed: int = 0,
              **kwargs) -> list[CurveTask]:
        """Yield up to ``num_tasks`` tasks (all available when None)."""
        ...


SOURCES: dict[str, type] = {}


def register_source(kind: str):
    """Class decorator: register ``cls(arg, spec=...)`` under ``kind``."""
    def deco(cls):
        SOURCES[kind] = cls
        return cls
    return deco


def get_source(spec: str) -> "CurveSource":
    """Resolve ``"<kind>:<arg>"`` (or bare ``"<kind>"``) to a source."""
    kind, _, arg = str(spec).partition(":")
    try:
        cls = SOURCES[kind]
    except KeyError:
        raise ValueError(f"unknown dataset source kind {kind!r} in "
                         f"{spec!r}; available: {sorted(SOURCES)}") from None
    return cls(arg, spec=spec)


def list_source_kinds() -> list[str]:
    return sorted(SOURCES)


# --------------------------------------------------------------------------
# synthetic (the LCBench-like prior in repro_torch.data.curves)
# --------------------------------------------------------------------------
@register_source("synthetic")
class SyntheticSource:
    """Samples suites from the synthetic prior; the arg picks the regime.

    Variants mirror the benchmark suites: ``mixed`` (default), ``crossing``
    (rate anti-correlated with asymptote; rank-based promotion misled), and
    ``noisy-divergent``.
    """

    VARIANTS = {
        "": {},
        "mixed": {},
        "crossing": dict(crossing=True, diverge_prob=0.0),
        "noisy-divergent": dict(noise=0.03, diverge_prob=0.08),
    }

    def __init__(self, variant: str = "", spec: str | None = None):
        if variant not in self.VARIANTS:
            raise ValueError(f"unknown synthetic variant {variant!r}; "
                             f"expected one of {sorted(self.VARIANTS)}")
        self.variant = variant
        self.spec = spec if spec is not None else f"synthetic:{variant}"
        self.dataset_id = f"synthetic:{variant or 'mixed'}"
        self.maximize = True

    def tasks(self, num_tasks: int | None = None, seed: int = 0,
              **kwargs) -> list[CurveTask]:
        kw = dict(self.VARIANTS[self.variant])
        kw.update(kwargs)
        return sample_suite(seed, num_tasks if num_tasks is not None else 4,
                            **kw)


# --------------------------------------------------------------------------
# lcbench / ifbo artifacts on disk
# --------------------------------------------------------------------------
@register_source("lcbench")
@register_source("ifbo")
class LCBenchSource:
    """Tasks from an LCBench/ifBO-format npz artifact (see data.lcbench)."""

    def __init__(self, path: str, spec: str | None = None):
        if not path:
            raise ValueError("lcbench source needs a path: 'lcbench:<path>'")
        self.path = path
        self.spec = spec if spec is not None else f"lcbench:{path}"
        stem = os.path.splitext(os.path.basename(path))[0]
        self.dataset_id = f"lcbench:{stem}"
        self._artifact: LCBenchArtifact | None = None

    @property
    def artifact(self) -> LCBenchArtifact:
        if self._artifact is None:
            self._artifact = load_artifact(self.path)
        return self._artifact

    @property
    def maximize(self) -> bool:
        return self.artifact.maximize

    @property
    def names(self) -> list:
        return self.artifact.names

    @property
    def has_full(self) -> list:
        return self.artifact.has_full

    def tasks(self, num_tasks: int | None = None, seed: int = 0,
              **kwargs) -> list[CurveTask]:
        tasks = self.artifact.tasks
        return list(tasks if num_tasks is None else tasks[:num_tasks])
