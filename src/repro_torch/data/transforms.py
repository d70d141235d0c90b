"""Composable, invertible per-task standardization for curve datasets.

Counterpart of ``repro.data.transforms`` (a copy: the port imports nothing
of the reference).

Real learning-curve artifacts mix metric conventions — validation accuracy
(maximize), loss or error rate (minimize), arbitrary units — and arbitrary
budget grids (epochs, steps, log-spaced fidelities). The model stack wants
one convention: score space, where larger is always better, plus a
progression axis the Matern kernel sees as roughly uniform. These
transforms standardize *before* the GP's own fitted input/output
transforms (:mod:`repro_torch.core.transforms`) and carry their inverse, so
predictions can be reported back in the artifact's raw metric units.

Everything here is plain elementwise arithmetic, so the transforms work on
numpy arrays and torch tensors alike, and :class:`Compose` chains them (inverse runs
in reverse order). :class:`AffineTransform` is the ``maximize`` sign flip
the schedulers' curve predictor applies.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["AffineTransform", "LogWarp", "Compose", "metric_transform"]


class AffineTransform(NamedTuple):
    """``z = scale * y + shift`` with stored exact inverse.

    Covers the two metric standardizations the datasets need: the
    sign flip into score space (``scale=-1`` for minimized metrics) and
    per-task affine normalization fitted on observed cells.
    """

    scale: float = 1.0
    shift: float = 0.0

    def __call__(self, y):
        return y * self.scale + self.shift

    def inverse(self, z):
        return (z - self.shift) / self.scale

    def inverse_var(self, v):
        """Map a variance from transformed space back to raw units."""
        return v / (self.scale * self.scale)

    @classmethod
    def identity(cls) -> "AffineTransform":
        return cls(1.0, 0.0)

    @classmethod
    def sign(cls, maximize: bool) -> "AffineTransform":
        """Score-space convention: larger is always better."""
        return cls(1.0 if maximize else -1.0, 0.0)

    @classmethod
    def fit_normalize(cls, Y, mask) -> "AffineTransform":
        """Zero-mean / unit-std over the *observed* cells of one task."""
        Y = np.asarray(Y, np.float64)
        mask = np.asarray(mask, np.float64)
        cnt = max(float(mask.sum()), 1.0)
        mean = float((Y * mask).sum() / cnt)
        var = float((mask * (Y - mean) ** 2).sum() / cnt)
        std = float(np.sqrt(max(var, 1e-12)))
        return cls(1.0 / std, -mean / std)


class LogWarp(NamedTuple):
    """Progression warp ``u = log(t + offset)`` with exact inverse.

    Maps a multiplicative budget grid (epochs 1..m, log-spaced fidelities)
    onto an additively-spaced axis. ``offset`` keeps zero-based step counts
    in the kernel's domain.
    """

    offset: float = 0.0

    def __call__(self, t):
        return np.log(np.asarray(t, np.float64) + self.offset)

    def inverse(self, u):
        return np.exp(np.asarray(u, np.float64)) - self.offset


class Compose(NamedTuple):
    """Apply ``transforms`` left to right; invert right to left."""

    transforms: tuple

    def __call__(self, y):
        for tf in self.transforms:
            y = tf(y)
        return y

    def inverse(self, z):
        for tf in reversed(self.transforms):
            z = tf.inverse(z)
        return z

    def inverse_var(self, v):
        for tf in reversed(self.transforms):
            v = tf.inverse_var(v)
        return v


def metric_transform(maximize: bool = True, normalize: bool = False,
                     Y=None, mask=None):
    """Standard metric pipeline: sign flip, optionally per-task affine.

    With ``normalize=True`` the affine part is fitted on the observed cells
    of ``(Y, mask)`` *after* the sign flip, so score space is zero-mean /
    unit-std regardless of the artifact's metric units.
    """
    sign = AffineTransform.sign(maximize)
    if not normalize:
        return sign
    if Y is None or mask is None:
        raise ValueError("normalize=True needs Y and mask to fit on")
    norm = AffineTransform.fit_normalize(sign(np.asarray(Y, np.float64)),
                                         mask)
    return Compose((sign, norm))
