"""PyTorch port, what the mesh paths hand DTensor: none of the three
patterns the card's older PyTorch (2.11) refuses, on every family's smoke
config at (2, 2) and on the sequence-parallel MoE train step.

The card's DTensor stopped 13 of the 30 (2, 2) smoke cells and the MoE
configs' train cells where this container's (2.13) runs them, so the
refusals cannot be raised here. Instead every op DTensor propagates is
checked for them (a hook on ``ShardingPropagator``, as the verify recipe
lists a path's ops):

* a view that flattens dimensions of which one after the first is split
  (2.11: "Attempted to flatten multiple dimensions, with dimension 1 being
  sharded"; 2.13 makes a strided shard): the sequence-parallel projection
  and the loss's head (``layers._mm`` and ``layers._ce_chunk`` replicate
  the sequence first) and einsums over blocks (``layers._batch_local``);
* an elementwise op of a pending sum (``Partial``) and a broadcast operand
  (a bias) split over the same mesh axis (2.11: "redistribute from S(0) to
  P(sum)"): Griffin's gate biases (``griffin._rglru_gates`` reduces
  first);
* an ``index_put`` on a ``DTensor`` (2.11: "Shard dim -1 ... must be
  normalized", the embedding lookup's backward): ``layers.embed_lookup``
  looks up each rank's block instead.

Each family's prefill, decode and train step run in a ``fake`` group of 4
on ``meta`` blocks (the dry run's machinery, no data moves).
"""
import math

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.distributed.sharding import (SERVE_RULES, SP_ACT_RULES,
                                              contiguous_stride)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.train.optimizers import OptConfig

_VIEWS = ("aten.view.default", "aten._unsafe_view.default",
          "aten.reshape.default")
_ELEMENTWISE = ("aten.add.Tensor", "aten.sub.Tensor", "aten.mul.Tensor",
                "aten.div.Tensor")


def _groups(shape, new):
    """(input dims, output dims) of each run of dimensions a view merges
    or splits, size-1 dimensions left out."""
    new = list(new)
    if -1 in new:
        rest = math.prod(d for d in new if d != -1)
        new[new.index(-1)] = math.prod(shape) // max(rest, 1)
    ins = [i for i, s in enumerate(shape) if s != 1]
    outs = [j for j, s in enumerate(new) if s != 1]
    i = j = 0
    while i < len(ins) and j < len(outs):
        gi, go = [ins[i]], [outs[j]]
        pi, pj = shape[ins[i]], new[outs[j]]
        while pi != pj:
            if pi < pj and i + 1 < len(ins):
                i += 1
                gi.append(ins[i])
                pi *= shape[ins[i]]
            elif pj < pi and j + 1 < len(outs):
                j += 1
                go.append(outs[j])
                pj *= new[outs[j]]
            else:
                return
        yield gi, go
        i, j = i + 1, j + 1


def _specs(args):
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    for a in args:
        if isinstance(a, DTensorSpec):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _specs(a)


def refused_by_older_dtensor(op_schema) -> str | None:
    """The pattern of the module docstring ``op_schema`` matches, or
    None."""
    from torch.distributed.tensor import Partial, Shard

    op = str(op_schema.op)
    args = op_schema.args_schema
    if op in _VIEWS:
        spec, new = args[0], args[1]
        shape = tuple(spec.shape)
        for gi, go in _groups(shape, new):
            if len(gi) > 1 and len(go) == 1:
                for p in spec.placements:
                    if isinstance(p, Shard) and p.dim % len(shape) in gi[1:]:
                        return (f"{op} flattens dims {gi} of {shape} with "
                                f"dim {p.dim} split ({spec.placements})")
    if op in _ELEMENTWISE:
        specs = list(_specs(args))
        for m in range(len(specs[0].placements) if specs else 0):
            pending = [s for s in specs
                       if isinstance(s.placements[m], Partial)]
            split = [s for s in specs if isinstance(s.placements[m], Shard)]
            if any(b.ndim < p.ndim for p in pending for b in split):
                return (f"{op} of a pending sum and a split broadcast "
                        f"operand on mesh dim {m}: "
                        f"{[(tuple(s.shape), s.placements) for s in specs]}")
    if op.startswith("aten.index_put"):
        return f"{op} on a DTensor"
    return None


@pytest.fixture
def refusals(monkeypatch):
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    found = []
    real = ShardingPropagator.propagate_op_sharding_non_cached

    def hooked(self, op_schema):
        why = refused_by_older_dtensor(op_schema)
        if why:
            found.append(why)
        return real(self, op_schema)

    monkeypatch.setattr(ShardingPropagator,
                        "propagate_op_sharding_non_cached", hooked)
    # the propagator caches by schema: start empty so every op is seen
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    cache = getattr(prop, "propagate_op_sharding", None)
    if hasattr(cache, "cache_clear"):
        cache.cache_clear()
    return found


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_cells_avoid_what_older_dtensor_refuses(refusals, arch):
    """Prefill, decode and a train step of the smoke config on (2, 2), the
    cells of ``chip_smoke.py``'s ``coverage_2x2``."""
    cfg = get_smoke_config(arch)
    patches = cfg.num_patch_tokens or 0
    with dryrun.fake_world(4):
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        for kind in ("prefill", "decode"):
            dryrun.plan_serve(cfg, 4, 16 + patches, mesh, kind, SERVE_RULES,
                              32 + patches)
        dryrun.plan_train(cfg, 4, 16 + patches, mesh, OptConfig())
    assert refusals == []


def test_sequence_parallel_moe_train_step(refusals):
    """The MoE train step with sequence-parallel layer boundaries (the
    reference's choice for its MoE train cells) on (1, 8): the projections
    take a sequence split over 'model' against weights split over it."""
    cfg = get_smoke_config("qwen3_moe_235b")
    with dryrun.fake_world(8):
        mesh = make_debug_mesh(1, 8, device_type="cpu")
        dryrun.plan_train(cfg, 8, 16, mesh, OptConfig(), 1, None,
                          SP_ACT_RULES)
    assert refusals == []


def test_the_checker_sees_each_pattern():
    """Each pattern, made on purpose, is reported."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._op_schema import OpSchema

    with dryrun.fake_world(4):
        mesh = make_debug_mesh(2, 2, device_type="cpu")

        def spec(shape, placements):
            local = list(shape)
            for m, p in enumerate(placements):
                if isinstance(p, Shard):
                    local[p.dim] //= mesh.size(m)
            t = DTensor.from_local(torch.empty(local, device="meta"), mesh,
                                   placements, run_check=False,
                                   shape=torch.Size(shape),
                                   stride=contiguous_stride(shape))
            return t._spec

        view = OpSchema(torch.ops.aten.view.default,
                        (spec((4, 4, 16), (Shard(0), Shard(1))), [16, 16]),
                        {})
        add = OpSchema(torch.ops.aten.add.Tensor,
                       (spec((4, 16), (Replicate(), Partial())),
                        spec((16,), (Replicate(), Shard(0)))), {})
        fine = OpSchema(torch.ops.aten.view.default,
                        (spec((4, 4, 16), (Shard(0), Replicate())), [16, 16]),
                        {})
        assert "flattens" in refused_by_older_dtensor(view)
        assert "pending sum" in refused_by_older_dtensor(add)
        assert refused_by_older_dtensor(fine) is None
