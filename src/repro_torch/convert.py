"""Carrying parameters, probes and fitted state between the reference and
the port, as plain numpy arrays.

This module needs nothing of the reference implementation: the caller turns
a reference state into numpy (``np.asarray`` on each field) and its config
into a dict (``dataclasses.asdict``), and reads the port's parameters back
with :func:`params_to_numpy`. A batched state (the reference's
``fit_batch``: every array with a leading task axis) crosses the same way,
and is served by :func:`repro_torch.core.posterior.posterior_batch`. The
curve transformer's and the amortizer's parameter trees cross with
:func:`tree_from_numpy` / :func:`tree_to_numpy`: the reference's pytree of
arrays (nested dicts, as ``jax.tree_util.tree_map(np.asarray, params)``
gives it) or its flat ``/``-joined paths, to and from the port's nested dict
of tensors with the same paths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from ._device import resolve_device
from .core.state import LKGPConfig, LKGPParams, LKGPState
from .core.transforms import TTransform, XTransform, YTransform

__all__ = ["params_from_numpy", "params_to_numpy", "probes_from_numpy",
           "state_from_reference", "tree_from_numpy", "tree_to_numpy"]

_PARAM_FIELDS = LKGPParams._fields


def params_from_numpy(arrays: Mapping[str, Any], *,
                      dtype: torch.dtype = torch.float64,
                      device=None) -> LKGPParams:
    """Build :class:`LKGPParams` from a mapping of its four raw fields:
    ``raw_x_lengthscale`` of shape (d,) and three scalars, or, for a batch
    of B tasks, (B, d) and three (B,) arrays."""
    dev = resolve_device(device)
    missing = [f for f in _PARAM_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"params arrays are missing {missing}")
    fields = {f: torch.as_tensor(np.asarray(arrays[f]), dtype=dtype, device=dev)
              for f in _PARAM_FIELDS}
    lead = tuple(fields["raw_x_lengthscale"].shape[:-1])
    if len(lead) > 1 or fields["raw_x_lengthscale"].ndim == 0:
        raise ValueError("raw_x_lengthscale must have shape (d,) or (B, d)")
    for f in _PARAM_FIELDS[1:]:
        fields[f] = fields[f].reshape(lead)
    return LKGPParams(**fields)


def params_to_numpy(params: LKGPParams) -> dict[str, np.ndarray]:
    """The four raw fields of ``params`` as numpy arrays, under the
    reference's field names (the inverse of :func:`params_from_numpy`)."""
    return {f: getattr(params, f).detach().cpu().numpy() for f in _PARAM_FIELDS}


def probes_from_numpy(probes, mask: torch.Tensor) -> torch.Tensor:
    """A numpy (p, n, m) probe stack (e.g. the reference's Rademacher draws)
    as a tensor in ``mask``'s dtype and on its device."""
    z = torch.tensor(np.asarray(probes), dtype=mask.dtype, device=mask.device)
    if z.ndim != 3 or z.shape[1:] != mask.shape:
        raise ValueError(f"probes must be (p, {mask.shape[0]}, "
                         f"{mask.shape[1]}), got {tuple(z.shape)}")
    return z


def state_from_reference(arrays: Mapping[str, Any],
                         config: Mapping[str, Any] | LKGPConfig | None = None,
                         *, dtype: torch.dtype = torch.float64,
                         device=None) -> LKGPState:
    """Build an :class:`LKGPState` from a reference state's numpy arrays.

    ``arrays`` is a flat mapping with the keys ``params.<field>`` (the four
    raw fields), ``X``, ``t``, ``Y``, ``mask``, ``x_tf.lo`` / ``x_tf.hi``,
    ``t_tf.log_t1`` / ``t_tf.log_tm`` and ``y_tf.shift`` / ``y_tf.scale``.
    ``config`` is a dict of ``LKGPConfig`` fields (unknown keys are an
    error). ``device=None`` means the GPU.

    A batched state (B tasks) has ``X`` (B, n, d), ``t`` (B, m), ``Y`` and
    ``mask`` (B, n, m), parameters as :func:`params_from_numpy` takes them,
    and every transform field with the leading B axis.
    """
    dev = resolve_device(device)
    if config is None:
        config = LKGPConfig()
    elif not isinstance(config, LKGPConfig):
        known = {f.name for f in dataclasses.fields(LKGPConfig)}
        unknown = sorted(set(config) - known)
        if unknown:
            raise ValueError(f"unknown LKGPConfig fields {unknown}")
        config = LKGPConfig(**config)

    def tensor(key):
        if key not in arrays:
            raise KeyError(f"state arrays are missing {key!r}")
        return torch.as_tensor(np.asarray(arrays[key]), dtype=dtype,
                               device=dev)

    params = params_from_numpy(
        {f: arrays[f"params.{f}"] for f in _PARAM_FIELDS
         if f"params.{f}" in arrays},
        dtype=dtype, device=dev)
    X, t, Y, mask = tensor("X"), tensor("t"), tensor("Y"), tensor("mask")
    if X.ndim not in (2, 3):
        raise ValueError(f"X must have shape (n, d) or (B, n, d), got "
                         f"{tuple(X.shape)}")
    *lead, n, d = X.shape
    lead = tuple(lead)
    m = t.shape[-1]
    if tuple(t.shape) != lead + (m,):
        raise ValueError(f"t must have shape {lead + (m,)}, got "
                         f"{tuple(t.shape)}")
    if Y.shape != lead + (n, m) or mask.shape != lead + (n, m):
        raise ValueError(f"Y and mask must have shape {lead + (n, m)}, got "
                         f"{tuple(Y.shape)} and {tuple(mask.shape)}")
    if params.raw_x_lengthscale.shape != lead + (d,):
        raise ValueError(f"raw_x_lengthscale must have shape {lead + (d,)}")
    return LKGPState(
        params=params, X=X, t=t, Y=Y, mask=mask,
        x_tf=XTransform(lo=tensor("x_tf.lo"), hi=tensor("x_tf.hi")),
        t_tf=TTransform(log_t1=tensor("t_tf.log_t1"),
                        log_tm=tensor("t_tf.log_tm")),
        y_tf=YTransform(shift=tensor("y_tf.shift"),
                        scale=tensor("y_tf.scale")),
        config=config)


def tree_from_numpy(tree: Mapping[str, Any], *,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> dict:
    """A parameter tree of numpy arrays (nested dicts, or flat paths joined
    with ``/``) as the port's nested dict of ``dtype`` tensors on ``device``
    (``None``: the GPU)."""
    dev = resolve_device(device)
    out: dict = {}
    for key, value in tree.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        if isinstance(value, Mapping):
            node.setdefault(leaf, {}).update(
                tree_from_numpy(value, dtype=dtype, device=dev))
        else:
            host = np.asarray(value)  # lint: disable=RT103 (a host leaf)
            node[leaf] = torch.tensor(host, dtype=dtype, device=dev)
    return out


def tree_to_numpy(tree: Mapping[str, Any]) -> dict:
    """The port's parameter tree as nested dicts of numpy arrays, the
    reference's pytree layout (the inverse of :func:`tree_from_numpy`)."""
    return {k: tree_to_numpy(v) if isinstance(v, Mapping)
            else v.detach().cpu().numpy() for k, v in tree.items()}
