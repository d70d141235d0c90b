"""Logical-axis sharding rules over a ``DeviceMesh`` (counterpart of
``repro.distributed.sharding``).

Parameters and activations carry *logical* axis names (the models'
parameter tables); the rules map logical names to mesh axes. The resolver
drops any mesh axis that does not evenly divide the dimension and never uses
a mesh axis twice within one spec, so e.g. phi3's 40 heads fall back to
fused-dim sharding and batch-1 decode shapes fall back to replication, by
construction rather than by special case.

The reference's objects and their counterparts here:

* ``PartitionSpec``: a tuple with one entry per tensor dimension, each
  ``None``, a mesh axis name or a tuple of names (:func:`logical_to_pspec`,
  the reference's rule, which reads only ``mesh.shape``: any object whose
  ``.shape`` maps axis name -> size will do, so specs of meshes no machine
  here can build are computed all the same).
* ``NamedSharding``: :class:`NamedSharding` (mesh, spec), whose
  :meth:`~NamedSharding.placements` are the ``DTensor`` placements on a
  ``DeviceMesh``: ``Shard(d)`` on each mesh dimension a spec entry names,
  ``Replicate()`` on the others. A dimension split over two axes takes two
  ``Shard(d)`` placements, which DTensor applies in mesh-dimension order
  (data-major), where JAX splits ``P(("model", "data"))`` model-major: the
  values and the bytes per rank agree, the block a rank holds does not.
* ``with_sharding_constraint``: the ``constrain`` of :func:`make_constrain`,
  ``DTensor.redistribute`` on a ``DTensor`` and the identity on a plain
  tensor (so a one-device path keeps its bits). Redistributing a
  ``Partial`` sum to ``Replicate`` is the tensor-parallel all-reduce.

The active mesh (:func:`set_active_mesh`) switches the models' MoE onto its
expert-parallel path; ``None`` (one device) keeps the grouped einsum path.
"""
from __future__ import annotations

import hashlib
import itertools
import math
from typing import Any, Mapping, NamedTuple

import torch

__all__ = ["TP_RULES", "FSDP_RULES", "ZERO_RULES", "SERVE_RULES", "ACT_RULES",
           "rules_for", "logical_to_pspec", "make_constrain",
           "param_shardings", "batch_shardings", "dp_axes",
           "set_active_mesh", "get_active_mesh", "ZERO_ACT_RULES",
           "SERVE_DECODE_RULES", "SP_ACT_RULES", "NamedSharding",
           "mesh_shape", "spec_placements", "shard_tensor", "shard_params",
           "table_shapes", "spec_bytes", "param_bytes_per_rank",
           "cache_spec", "to_local", "param_placer", "full_value",
           "opt_logical", "state_shardings", "placed_zeros",
           "sum_to_replicas", "keyed_block", "block_ranges", "slab_rows",
           "drawn_slab_bytes", "SLAB_BYTES", "slabs", "slab_seed",
           "contiguous_stride"]

# Mesh context for the layers with an explicit-collective path (the MoE's
# expert parallelism). Set by the serve steps; None on one device.
_ACTIVE_MESH: list = [None]


def set_active_mesh(mesh):
    _ACTIVE_MESH[0] = mesh


def get_active_mesh():
    return _ACTIVE_MESH[0]


# -- parameter rules --------------------------------------------------------
TP_RULES: dict[str, Any] = {
    "vocab": "model",
    "heads_fused": "model",
    "kv_fused": "model",
    "heads": "model",
    "mlp": "model",
    "experts": "model",
    "rnn": "model",
    "embed": None,
    "embed_out": None,
    "rnn_in": None,
    "moe_groups": "data",
    "layers": None,
    "batch": None,          # parameters have no batch axis
}

# FSDP additionally shards the d_model ("embed") dim of weights over 'data'
# (ZeRO-3 style). Used for the >= 10B archs.
FSDP_RULES = dict(TP_RULES, embed="data", rnn_in="data", embed_out="data")

# Pure ZeRO-DP: no tensor parallelism; every weight shards on its d_model
# dim over both axes, the embedding's vocab dim over what remains.
ZERO_RULES = dict(
    TP_RULES,
    heads_fused=None, kv_fused=None, heads=None, mlp=None,
    experts=None, rnn=None,
    vocab=("data", "model"),
    embed=("data", "model"), rnn_in=("data", "model"),
    embed_out=("data", "model"),
)
ZERO_ACT_RULES = {
    "batch": ("pod", "data", "model"),
    "seq": None,
    "heads": None, "vocab": None, "mlp": None, "embed": None,
    "experts": None, "moe_groups": None, "rnn": None,
}

# Serving: weights stay resident (tensor parallel over 'model'), and the
# MoE / MLP inner dim also over 'data' so the 480B-class experts fit.
SERVE_RULES = dict(TP_RULES, mlp=("model", "data"))

# Decode-specific layout: 2D tensor parallelism over both axes.
SERVE_DECODE_RULES = dict(
    TP_RULES,
    embed="model", mlp="data", heads_fused=None, kv_fused=None, heads=None,
    vocab="data", experts="model", rnn="data", rnn_in="model",
    embed_out="data",
)

# -- activation rules -------------------------------------------------------
ACT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "heads": "model",
    "vocab": "model",
    "mlp": "model",
    "embed": None,
    "experts": "model",
    "moe_groups": "data",
    "rnn": "model",
}

# Sequence parallelism for the MoE trains: layer-boundary activations shard
# their sequence dim over 'model'.
SP_ACT_RULES = dict(ACT_RULES, seq="model")


def rules_for(cfg, param_count: int | None = None) -> dict[str, Any]:
    """Pick parameter rules by model scale (FSDP for the big archs)."""
    from ..models.registry import count_params

    n = param_count if param_count is not None else count_params(cfg)
    return FSDP_RULES if n >= 1e10 else TP_RULES


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``, or ``mesh.shape`` itself for
    any other object (a mapping, as the reference's ``Mesh.shape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def _resolve(name, rules):
    axes = rules.get(name, None) if name is not None else None
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def logical_to_pspec(logical, rules: Mapping[str, Any], mesh,
                     shape) -> tuple:
    """Map a logical-axis tuple to a spec valid for ``shape``: one entry a
    dimension, ``None``, an axis name or a tuple of names."""
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, logical):
        names = name if isinstance(name, tuple) else (name,)
        axes = []
        for n in names:
            axes.extend(_resolve(n, rules))
        # drop axes not in the mesh, already used, or not dividing the dim
        kept = []
        prod = 1
        for a in axes:
            if a not in sizes or a in used:
                continue
            if dim % (prod * sizes[a]) != 0:
                continue
            kept.append(a)
            prod *= sizes[a]
        used.update(kept)
        out.append(_entry(kept))
    return tuple(out)


def _entry(axes: list):
    """A spec entry of the mesh axes kept for a dimension: ``None``, one
    name, or a tuple of names (``PartitionSpec``'s normal form)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(spec: tuple, mesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` on a ``DeviceMesh``:
    ``Shard(d)`` on every mesh dimension entry ``d`` names, ``Replicate()``
    on the rest. A mesh dimension of one rank holds whole dimensions, so it
    is ``Replicate()`` whatever the spec says (DTensor's view rules refuse
    to reshape a dimension sharded even over one rank)."""
    from torch.distributed.tensor import Replicate, Shard

    where = {a: d for d, entry in enumerate(spec) for a in _entry_axes(entry)}
    return tuple(Shard(where[a]) if a in where and mesh.size(i) > 1
                 else Replicate()
                 for i, a in enumerate(mesh.mesh_dim_names))


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, tuple, type(None))) for e in x)


def _tree_map2(fn, logical, other):
    """``fn(logical leaf, other leaf)`` over two trees of the same nesting
    (dicts; a logical leaf is a tuple of names)."""
    if isinstance(logical, dict):
        return {k: _tree_map2(fn, v, other[k]) for k, v in logical.items()}
    return fn(logical, other)


def table_shapes(table: dict) -> dict:
    """A parameter table's shapes nested as the parameter tree (the
    reference's ``eval_shape`` of ``model.init``)."""
    out: dict[str, Any] = {}
    for name, (shape, _, _) in table.items():
        node = out
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.Size(shape)
    return out


def _shape(x):
    return tuple(x) if isinstance(x, torch.Size) else tuple(x.shape)


def param_shardings(logical_tree, mesh, rules, shape_tree):
    """A :class:`NamedSharding` tree for parameters (the parameters'
    nesting). ``shape_tree`` holds tensors, ``torch.Size`` s or anything
    with ``.shape``."""
    return _tree_map2(
        lambda logical, s: NamedSharding(
            mesh, logical_to_pspec(logical, rules, mesh, _shape(s))),
        logical_tree, shape_tree)


def dp_axes(mesh) -> tuple[str, ...]:
    sizes = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def batch_shardings(specs: dict, mesh):
    """Shard every batch input over the data-parallel axes (dim 0)."""
    sizes = mesh_shape(mesh)
    dp = dp_axes(mesh)

    def one(sds):
        shape = _shape(sds)
        prod = 1
        kept = []
        for a in dp:
            if shape[0] % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        spec = (_entry(kept),) + (None,) * (len(shape) - 1)
        return NamedSharding(mesh, spec)

    return {k: one(v) for k, v in specs.items()}


def cache_spec(shape, dtype: torch.dtype, mesh, prefer: str = "time"
               ) -> tuple:
    """The reference's cache layout of one (L, B, ...) cache leaf.

    The batch axis over the data-parallel axes; then the first of these
    that ``model`` divides goes over ``model``: with ``prefer="time"`` the
    time axis of an (L, B, T, H, Dh) leaf, then (``"width"``, the layout a
    prefill emits) the kv-heads axis, the head_dim / width axis, any other
    trailing axis. Integer leaves keep their trailing axes whole; a leaf of
    rank below 2 is replicated.
    """
    ndim = len(shape)
    if ndim < 2:
        return ()
    sizes = mesh_shape(mesh)
    prod = 1
    kept = []
    for a in dp_axes(mesh):
        if shape[1] % (prod * sizes[a]) == 0:
            kept.append(a)
            prod *= sizes[a]
    tp = sizes.get("model", 1)
    rest = [None] * (ndim - 2)
    if dtype.is_floating_point:
        order = []
        if ndim >= 5:
            if prefer == "time":
                order.append(0)               # T axis
            order.append(ndim - 4)            # kv-heads axis
        order.append(ndim - 3)                # head_dim / width axis
        order += [i for i in range(ndim - 2) if i not in order and i != 0]
        for i in order:
            if 0 <= i < ndim - 2 and shape[i + 2] % tp == 0 \
                    and shape[i + 2] >= tp:
                rest[i] = "model"
                break
    return (None, _entry(kept), *rest)


def to_local(t, mesh, spec: tuple, partial=None) -> torch.Tensor:
    """This rank's block of ``t`` laid out by ``spec``: a ``DTensor`` is
    redistributed first, a plain tensor (the same on every rank) is cut.

    Under autograd the block's gradient is declared partial on the mesh
    axes ``partial`` (default: every axis ``spec`` replicates ``t`` over)
    where ``t`` is replicated: a rank's computation on its block covers only
    its share (its experts, its tokens), and DTensor sums the shares into
    the gradient of ``t``; on the other replicated axes the ranks' gradients
    are copies."""
    from torch.distributed.tensor import DTensor, Partial

    placements = spec_placements(spec, mesh)
    if not isinstance(t, DTensor):
        t = shard_tensor(t, mesh, spec)
    names = mesh.mesh_dim_names
    grads = [Partial() if p.is_replicate()
             and (partial is None or names[i] in partial) else p
             for i, p in enumerate(placements)]
    return t.redistribute(mesh, placements).to_local(grad_placements=grads)


def full_value(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s whole value on every rank (a plain tensor is its
    own)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def make_constrain(mesh, act_rules: Mapping[str, Any] | None = None):
    """The activation-constraint callback passed into the model functions:
    a ``DTensor`` is redistributed to its activation layout, a plain tensor
    passes unchanged."""
    from torch.distributed.tensor import DTensor

    act_rules = act_rules or ACT_RULES

    def constrain(t, logical):
        if not isinstance(t, DTensor):
            return t
        spec = logical_to_pspec(logical, act_rules, mesh, t.shape)
        return t.redistribute(mesh, spec_placements(spec, mesh))

    return constrain


def shard_tensor(t: torch.Tensor, mesh, spec: tuple):
    """Place a full tensor that every rank holds as a ``DTensor`` of
    ``spec``: each rank keeps its own block (no communication), split in
    mesh-dimension order as DTensor splits it."""
    from torch.distributed.tensor import DTensor, Shard

    placements = spec_placements(spec, mesh)
    t = t.contiguous()
    local = t
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            # DTensor's split: torch.chunk, ranks past the last chunk empty
            parts = local.chunk(mesh.size(i), dim=pl.dim)
            r = mesh.get_local_rank(i)
            local = parts[r] if r < len(parts) else local.narrow(pl.dim,
                                                                 0, 0)
    # a block smaller than the tensor is copied, so the full tensor can go;
    # a whole one (every axis of one rank) shares its storage
    if local.numel() != t.numel():
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def shard_params(params, mesh, rules, logical):
    """Place a parameter tree (every rank holding the same full tree) by
    ``rules``; a leaf's full tensor is dropped once its block is taken."""
    return _tree_map2(
        lambda lg, p: shard_tensor(
            p, mesh, logical_to_pspec(lg, rules, mesh, p.shape)),
        logical, params)


def param_placer(table: dict, mesh, rules):
    """A ``place(name, seed, std, dtype, device)`` for ``build_params``
    (``model.init(..., place=...)``): this rank's block of the leaf
    ``name`` of ``table``, laid out by ``rules``, drawn by
    :func:`keyed_block` and wrapped in a ``DTensor``. The values are those
    of the keyed stream (its own stream, not the reference's), the same on
    every mesh as on one device; a rank holds its blocks plus one slab
    (:data:`SLAB_BYTES` of float32) at a time, never a whole leaf."""
    from torch.distributed.tensor import DTensor

    sizes = mesh_shape(mesh)
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))

    def place(name, seed, std, dtype, device):
        shape, logical, _ = table[name]
        spec = logical_to_pspec(logical, rules, mesh, shape)
        local = keyed_block(seed, name, shape, std, spec, sizes, coords,
                            dtype, device)
        return DTensor.from_local(local, mesh, spec_placements(spec, mesh),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))
    return place


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (nothing made)."""
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.append(n)
        n *= d
    return tuple(reversed(stride))


# -- the keyed, mesh-independent init ----------------------------------------
SLAB_BYTES = 64 * 2 ** 20       # float32 bytes of one slab, at most


def slab_rows(shape) -> int:
    """Rows of the second-to-last axis in one slab of a leaf of ``shape``:
    as many as :data:`SLAB_BYTES` of float32 hold, at least one. A leaf of
    rank below 2 is one slab."""
    if len(shape) < 2:
        return 1
    return max(1, min(shape[-2], SLAB_BYTES // (4 * max(1, shape[-1]))))


def block_ranges(shape, spec: tuple, sizes: Mapping[str, int],
                 coords: Mapping[str, int]) -> list[tuple[int, int]]:
    """The ``[lo, hi)`` of each dimension of the block that the rank at
    ``coords`` holds of a tensor of ``shape`` laid out by ``spec``, split
    as DTensor splits it: over the mesh axes in mesh order (``sizes``'
    order), each by ``torch.chunk`` (ranks past the last chunk empty)."""
    ranges = [(0, n) for n in shape]
    where = {a: d for d, entry in enumerate(spec) for a in _entry_axes(entry)}
    for axis, k in sizes.items():
        if axis not in where or k == 1:
            continue
        d = where[axis]
        lo, hi = ranges[d]
        n = hi - lo
        step = -(-n // k)
        c = coords[axis]
        ranges[d] = (lo + min(c * step, n), lo + min(c * step + step, n))
    return ranges


def slabs(shape, ranges):
    """(lead index, row range) of every slab of a leaf of ``shape`` that
    meets the block ``ranges``: one index of each leading axis times
    :func:`slab_rows` rows of the second-to-last axis (a leaf of rank below
    2 is one slab, lead ``()``, rows ``(0, 1)``)."""
    if len(shape) < 2:
        if all(hi > lo for lo, hi in ranges):
            yield (), (0, 1)
        return
    if any(hi <= lo for lo, hi in ranges):
        return
    rows = slab_rows(shape)
    r_lo, r_hi = ranges[-2]
    leads = [range(lo, hi) for lo, hi in ranges[:-2]]
    for lead in itertools.product(*leads):
        for j in range(r_lo // rows, -(-r_hi // rows)):
            yield lead, (j * rows, min(j * rows + rows, shape[-2]))


def slab_seed(seed: int, name: str, lead: tuple, row0: int) -> int:
    key = f"{seed}/{name}/{','.join(map(str, lead))}/{row0}".encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") \
        & (2 ** 63 - 1)


def drawn_slab_bytes(shape, ranges) -> int:
    """Float32 bytes of the largest slab a block of ``ranges`` draws."""
    if len(shape) < 2:
        return 4 * math.prod(shape) if all(hi > lo for lo, hi in ranges) \
            else 0
    return max((4 * (r1 - r0) * shape[-1]
                for _, (r0, r1) in slabs(shape, ranges)), default=0)


def keyed_block(seed: int, name: str, shape, std: float, spec: tuple,
                sizes: Mapping[str, int], coords: Mapping[str, int],
                dtype: torch.dtype, device) -> torch.Tensor:
    """The block of the leaf ``name`` (of ``shape``) that the rank at
    ``coords`` on a mesh of ``sizes`` holds under ``spec``, from the keyed
    stream: ``std`` times a standard normal, cast to ``dtype`` (``std``
    0: zeros, no draw).

    Each value is a pure function of (``seed``, ``name``, its position in
    the leaf): the leaf is tiled into slabs (:func:`slabs`, independent of
    the mesh), each drawn in float32 from a generator on ``device`` seeded
    by a SHA-256 of (``seed``, ``name``, the slab's index). The rank draws
    every slab that meets its block, scales it, copies its part into the
    block (the cast) and frees it: its peak is the block plus one slab.
    An empty ``spec`` entry everywhere (``(None,) * len(shape)``, no
    ``sizes``) gives the whole leaf, equal bit for bit to the blocks of
    every rank on any mesh, on one device type (CPU and CUDA generators
    differ)."""
    ranges = block_ranges(shape, spec, sizes, coords)
    local = tuple(hi - lo for lo, hi in ranges)
    if std == 0:
        return torch.zeros(local, dtype=dtype, device=device)
    out = torch.empty(local, dtype=dtype, device=device)
    if len(shape) < 2:
        if out.numel():
            gen = torch.Generator(device=device)
            gen.manual_seed(slab_seed(seed, name, (), 0))
            slab = torch.randn(tuple(shape), generator=gen,
                               dtype=torch.float32, device=device).mul_(std)
            out.copy_(slab[tuple(slice(lo, hi) for lo, hi in ranges)])
        return out
    gen = torch.Generator(device=device)
    (r_lo, r_hi), (c_lo, c_hi) = ranges[-2:]
    for lead, (r0, r1) in slabs(shape, ranges):
        gen.manual_seed(slab_seed(seed, name, lead, r0))
        slab = torch.randn((r1 - r0, shape[-1]), generator=gen,
                           dtype=torch.float32, device=device).mul_(std)
        a, b = max(r0, r_lo), min(r1, r_hi)
        at = tuple(i - lo for i, (lo, _) in zip(lead, ranges))
        out[at + (slice(a - r_lo, b - r_lo),)].copy_(
            slab[a - r0:b - r0, c_lo:c_hi])
        del slab
    return out


def spec_bytes(shape, spec: tuple, mesh, itemsize: int) -> int:
    """Bytes of one rank's block of a tensor of ``shape`` under ``spec``."""
    sizes = mesh_shape(mesh)
    n = math.prod(shape)
    for e in spec:
        n //= math.prod(sizes[a] for a in _entry_axes(e))
    return n * itemsize


def param_bytes_per_rank(table: dict, rules, mesh, itemsize: int) -> int:
    """Bytes of parameters one rank holds when a table's tree is placed by
    ``rules`` on ``mesh`` (any object with a ``.shape`` mapping)."""
    return sum(spec_bytes(shape, logical_to_pspec(logical, rules, mesh,
                                                  shape), mesh, itemsize)
               for shape, logical, _ in table.values())


def opt_logical(logical, opt_cfg) -> dict:
    """The optimizer moments' logical axes (the reference's
    ``_state_logical``): AdamW's ``m`` and ``v`` take the parameter's;
    Adafactor's row moment ``vr`` drops the last axis, its column moment
    ``vc`` the second-last."""
    if opt_cfg.name == "adamw":
        return {"m": logical, "v": logical}

    def tmap(fn, tree):
        if isinstance(tree, dict):
            return {k: tmap(fn, v) for k, v in tree.items()}
        return fn(tree)

    def row(lg):
        return lg[:-1]

    def col(lg):
        return (*lg[:-2], lg[-1]) if len(lg) >= 2 else lg
    return {"vr": tmap(row, logical), "vc": tmap(col, logical)}


def state_shardings(model, mesh, rules=None, opt_cfg=None):
    """The train state's layout on ``mesh``: a ``TrainState`` of
    :class:`NamedSharding` trees, the parameters by ``rules`` (default
    :func:`rules_for`), the moments by :func:`opt_logical` on their own
    shapes. The step is ``None``: a plain tensor every rank holds alike
    (the reference's replicated ``P()``)."""
    from ..train.optimizers import OptConfig, init_opt_state, tree_map
    from ..train.trainer import TrainState

    opt_cfg = opt_cfg or OptConfig()
    rules = rules if rules is not None else rules_for(model.cfg)
    shapes = table_shapes(model.param_table)
    p_sh = param_shardings(model.logical, mesh, rules, shapes)
    o_shapes = init_opt_state(tree_map(
        lambda s: torch.empty(s, device="meta"), shapes), opt_cfg)
    o_logical = opt_logical(model.logical, opt_cfg)
    o_sh = _tree_map2(lambda lg, s: NamedSharding(
        mesh, logical_to_pspec(lg, rules, mesh, _shape(s))), o_logical,
        o_shapes)
    return TrainState(params=p_sh, opt_state=o_sh, step=None)


def placed_zeros(shape, dtype: torch.dtype, sharding: NamedSharding,
                 device) -> torch.Tensor:
    """A zero ``DTensor`` of ``shape`` laid out by ``sharding``, made as
    this rank's block on ``device`` (nothing of the full size is
    allocated)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    placements = sharding.placements
    local_shape, _ = compute_local_shape_and_global_offset(
        shape, sharding.mesh, placements)
    return DTensor.from_local(
        torch.zeros(local_shape, dtype=dtype, device=device), sharding.mesh,
        placements, run_check=False, shape=torch.Size(shape),
        stride=contiguous_stride(shape))


class _SumToReplicas(torch.autograd.Function):
    """The sum of each rank's share over ``groups``, which every rank of
    them then uses alike: each rank's upstream gradient is already the
    whole gradient of its share, so the backward passes it through."""

    @staticmethod
    def forward(ctx, x, groups):
        x = x.clone()
        for group in groups:
            torch.distributed.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_to_replicas(x: torch.Tensor, groups) -> torch.Tensor:
    """The sum of ``x`` over each process group of ``groups`` in turn (the
    reference's ``psum`` whose result the ranks use alike), differentiable
    with the gradient passed through."""
    return _SumToReplicas.apply(x, tuple(groups))
