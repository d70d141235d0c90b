"""Faults planted under the timed path, to show that the comparison fails
them: each a context manager that patches the program and restores it.

* ``state_unchanged``: ``extend`` returns the state it was given, so a
  request's new observations never reach the model (the step that returns
  its state unchanged).
* ``half_draws``: the Matheron prior draws lose their second half, so the
  variance is the spread of the other half (half of the batch left out, the
  mean taken over the rest).
* ``answer_altered``: the first configuration's final mean is moved by half
  an observed standard deviation where ``Posterior.final`` produces it.

A run on one card has no exchange between chips, so that fault has no place
here.
"""
from __future__ import annotations

import contextlib
import importlib

__all__ = ["FAULTS", "plant"]

FAULTS = ("state_unchanged", "half_draws", "answer_altered")


def _patches(name: str) -> list:
    core = importlib.import_module("repro_torch.core")
    post = importlib.import_module("repro_torch.core.posterior")
    if name == "state_unchanged":
        def unchanged(state, *args, **kwargs):
            return state

        return [(core, "extend", unchanged)]
    if name == "half_draws":
        draws = post.prior_residual_draws

        def half(*args, **kwargs):
            F, eps = draws(*args, **kwargs)
            keep = F.shape[0] // 2
            return F[:keep], eps[:keep]

        return [(post, "prior_residual_draws", half)]
    if name == "answer_altered":
        final = post.Posterior.final

        def altered(self, *args, **kwargs):
            mean, var = final(self, *args, **kwargs)
            mean = mean.clone()
            mean[0] += 0.5 * self._state.y_tf.scale
            return mean, var

        return [(post.Posterior, "final", altered)]
    raise ValueError(f"unknown fault {name!r}; expected one of {FAULTS}")


@contextlib.contextmanager
def plant(name: str):
    patches = _patches(name)
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, fn in patches:
            setattr(obj, attr, fn)
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
