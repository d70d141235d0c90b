"""Parameter tables and their materialisation (counterpart of
``repro.models.transformer``, the part the curve transformer and the
amortizer use).

A table maps a ``/``-joined path to ``(shape, logical_axes, fan_in or
None)``; :func:`build_params` turns it into a nested dict of tensors that
mirrors the reference's pytree, :func:`table_logical` into the same nesting
of logical axes. The decoder-only LM itself (``decoder_param_table``,
``decoder_forward`` / ``_loss`` / ``_prefill`` / ``_decode_step``), its MoE
FFN and the sharding imports it needs (``repro/models/transformer.py:19-22``)
wait for ROADMAP queue 1 item 14.
"""
from __future__ import annotations

from typing import Any

import torch

__all__ = ["build_params", "table_logical"]

_NORM_SUFFIXES = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")


def build_params(generator: torch.Generator, table: dict,
                 dtype: torch.dtype = torch.float32) -> dict:
    """Materialise a parameter tree from a table on ``generator``'s device.

    The reference's rules by name: norm scales (by suffix), ``*/b*`` and
    ``b*`` entries are zero; an entry with a fan-in is ``fan ** -0.5`` times
    a standard normal, one without ``0.02`` times it. Draws are float32 from
    ``generator`` in sorted-name order, then cast to ``dtype``. The values
    cannot equal the reference's (the PRNGs differ): carry its parameters
    across with :mod:`repro_torch.convert` where equal values are needed.
    """
    params: dict[str, Any] = {}
    dev = generator.device
    for name in sorted(table):
        shape, _, fan = table[name]
        if name.endswith(_NORM_SUFFIXES) or "/b" in name \
                or name.startswith("b"):
            arr = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            std = 0.02 if fan is None else fan ** -0.5
            z = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=dev)
            arr = (std * z).to(dtype)
        _assign(params, name, arr)
    return params


def table_logical(table: dict) -> dict:
    """The table's logical axes, nested as :func:`build_params` nests."""
    out: dict[str, Any] = {}
    for name, (_, logical, _) in table.items():
        _assign(out, name, logical)
    return out


def _assign(tree: dict, path: str, value) -> None:
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value
