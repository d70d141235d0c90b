"""PyTorch port, the keyed mesh-independent init (``sharding.keyed_block``,
``build_params``, ``param_placer``) on the CPU, no process group:

* every leaf of all ten smoke configs, assembled from the blocks of every
  rank at (1, 1), (2, 2), (1, 4), (2, 2, 2) and on an uneven split, equals
  the one-device init bit for bit, with slabs small enough that leaves span
  several;
* the split is DTensor's (``torch.chunk`` in mesh order);
* a rank's peak while it initialises is its blocks plus one slab, counted
  op by op and by the dry run's rule;
* the values follow the rule ``fan ** -0.5`` / 0.02 in distribution, zero
  leaves are zero, and the seed is the generator's initial seed.
"""
import itertools
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (FSDP_RULES, SERVE_RULES,
                                              TP_RULES, block_ranges,
                                              keyed_block, logical_to_pspec,
                                              param_bytes_per_rank, slabs)
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import StepCounter
from repro_torch.models import build_model
from repro_torch.models.transformer import build_params, init_std

SMALL_SLAB = 8192           # bytes: most smoke leaves span several slabs
MESHES = {"1x1": {"data": 1, "model": 1}, "2x2": {"data": 2, "model": 2},
          "1x4": {"data": 1, "model": 4},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}
RULES = {"serve": SERVE_RULES, "fsdp": FSDP_RULES, "tp": TP_RULES}


@pytest.fixture
def small_slabs(monkeypatch):
    monkeypatch.setattr(sharding, "SLAB_BYTES", SMALL_SLAB)


def _leaf(params, name):
    for part in name.split("/"):
        params = params[part]
    return params


def _coords(sizes):
    return [dict(zip(sizes, c))
            for c in itertools.product(*(range(k) for k in sizes.values()))]


def _assembled(seed, name, shape, std, spec, sizes, dtype):
    """The leaf put together from every rank's block (the replicas of a
    block must agree)."""
    out = torch.full(shape, float("nan"), dtype=dtype)
    for coords in _coords(sizes):
        block = keyed_block(seed, name, shape, std, spec, sizes, coords,
                            dtype, "cpu")
        at = tuple(slice(lo, hi) for lo, hi in
                   block_ranges(shape, spec, sizes, coords))
        seen = out[at]
        assert block.shape == seen.shape, (name, coords)
        done = ~torch.isnan(seen.float())
        assert torch.equal(seen[done], block[done]), (name, coords)
        out[at] = block
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_blocks_assemble_to_the_one_device_init(arch, small_slabs):
    """Every leaf, every mesh, every rank's block: the one-device leaf bit
    for bit, in float32 and in the config's bf16; a leaf sharded on an
    uneven split (its second-to-last axis over 3 ranks, then over 2 x 3)
    too."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    for dtype in (torch.float32, torch.bfloat16):
        full = model.init(torch.Generator().manual_seed(11), dtype)
        for mname, sizes in MESHES.items():
            mesh = types.SimpleNamespace(shape=sizes)
            for name, (shape, logical, fan) in model.param_table.items():
                spec = logical_to_pspec(logical, SERVE_RULES, mesh, shape)
                got = _assembled(11, name, shape, init_std(name, fan), spec,
                                 sizes, dtype)
                assert torch.equal(got, _leaf(full, name)), (mname, name)
        for name, (shape, _, fan) in model.param_table.items():
            if len(shape) < 2:
                continue
            for sizes, entry in (({"model": 3}, "model"),
                                 ({"data": 2, "model": 3},
                                  ("data", "model"))):
                spec = (None,) * (len(shape) - 2) + (entry, None)
                got = _assembled(11, name, shape, init_std(name, fan), spec,
                                 sizes, dtype)
                assert torch.equal(got, _leaf(full, name)), (sizes, name)


@pytest.mark.parametrize("n,sizes,entry", [
    (5, {"model": 4}, "model"), (7, {"model": 4}, "model"),
    (10, {"data": 2, "model": 3}, ("data", "model")),
    (9, {"pod": 2, "data": 2, "model": 2}, ("pod", "model")),
    (3, {"data": 4}, "data"), (16, {"data": 2, "model": 4},
                               ("data", "model"))])
def test_block_ranges_split_as_dtensor_does(n, sizes, entry):
    """``block_ranges`` against ``torch.chunk`` applied over the mesh axes
    in mesh order (DTensor's split, ``shard_tensor``'s): ranks past the
    last chunk hold nothing."""
    axes = (entry,) if isinstance(entry, str) else entry
    for coords in _coords(sizes):
        local = torch.arange(n)
        for axis, k in sizes.items():
            if axis in axes and k > 1:
                parts = local.chunk(k)
                c = coords[axis]
                local = parts[c] if c < len(parts) else local[:0]
        (lo, hi), = block_ranges((n,), (entry,), sizes, coords)
        assert torch.equal(torch.arange(lo, hi), local), (coords, lo, hi)


@pytest.mark.parametrize("arch,rules,mesh", [
    ("qwen3_moe_235b", "serve", "1x4"), ("qwen3_moe_235b", "fsdp", "2x2x2"),
    ("stablelm_12b", "serve", "2x2"), ("recurrentgemma_2b", "tp", "1x4"),
    ("rwkv6_1b6", "serve", "2x2x2"), ("whisper_tiny", "fsdp", "2x2")])
def test_init_peak_is_blocks_plus_one_slab(arch, rules, mesh, small_slabs):
    """``build_params`` with a ``place`` that draws each rank's blocks,
    counted op by op: the peak equals the dry run's rule (the blocks placed
    so far, this leaf's block and the largest slab it draws) on every rank,
    and stays within the blocks plus the largest slab."""
    model = build_model(get_smoke_config(arch))
    sizes = MESHES[mesh]
    plan_mesh = types.SimpleNamespace(shape=sizes)
    r = RULES[rules]
    for coords in _coords(sizes):
        def place(name, seed, std, dtype, device):
            shape, logical, _ = model.param_table[name]
            return keyed_block(seed, name, shape, std,
                               logical_to_pspec(logical, r, plan_mesh, shape),
                               sizes, coords, dtype, device)
        counter = StepCounter()
        with counter:
            params = build_params(torch.Generator().manual_seed(5),
                                  model.param_table, torch.bfloat16, place)
        blocks = sum(t.numel() * t.element_size()
                     for t in dryrun._tensors(params))
        rule = dryrun.init_peak_per_rank(model.param_table, r, plan_mesh,
                                         torch.bfloat16, coords)
        assert counter.peak == rule, (coords, counter.peak, rule)
        assert blocks == param_bytes_per_rank(model.param_table, r,
                                              plan_mesh, 2)
        row = max(4 * shape[-1] for shape, _, _ in
                  model.param_table.values() if shape)
        assert blocks < rule <= blocks + max(SMALL_SLAB, row)


def test_slabs_tile_every_leaf_once():
    """The slabs of a whole leaf cover each position once, at most
    ``SLAB_BYTES`` of float32 each (a row longer than that is one slab)."""
    for shape in ((3, 5, 1000), (40000, 1024), (7,), (2, 3, 20, 600000)):
        ranges = [(0, n) for n in shape]
        seen = torch.zeros(shape[:-1] if len(shape) > 1 else (1,),
                           dtype=torch.int32)
        for lead, (r0, r1) in slabs(shape, ranges):
            if len(shape) > 1:
                seen[lead + (slice(r0, r1),)] += 1
                assert (r1 - r0) * shape[-1] * 4 <= max(
                    sharding.SLAB_BYTES, 4 * shape[-1])
            else:
                seen += 1
        assert bool((seen == 1).all()), shape


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_values_follow_the_rule_in_distribution(arch):
    """Each drawn leaf's mean and standard deviation match N(0, std) with
    std = ``fan ** -0.5`` or 0.02 (5 standard errors, plus 2 % for the std);
    zero leaves are zero. The nesting is the table's."""
    model = build_model(get_smoke_config(arch))
    params = model.init(torch.Generator().manual_seed(3), torch.float32)
    for name, (shape, _, fan) in model.param_table.items():
        a = _leaf(params, name).double().numpy()
        assert a.shape == tuple(shape), name
        std = init_std(name, fan)
        if std == 0:
            assert not a.any(), name
            continue
        n = a.size
        assert abs(a.mean()) < 5 * std / np.sqrt(n), name
        if n > 1:
            assert abs(a.std() / std - 1) < 5 / np.sqrt(n) + 0.02, name


def test_seed_is_the_generators_initial_seed():
    """Draws made on the generator before do not shift the values, and the
    generator is not advanced; another seed gives other values."""
    table = build_model(get_smoke_config("stablelm_12b")).param_table
    want = build_params(torch.Generator().manual_seed(4), table)
    gen = torch.Generator().manual_seed(4)
    torch.randn(1000, generator=gen)
    state = gen.get_state()
    got = build_params(gen, table)
    assert torch.equal(gen.get_state(), state)
    other = build_params(torch.Generator().manual_seed(5), table)
    for name, (_, _, fan) in table.items():
        assert torch.equal(_leaf(got, name), _leaf(want, name)), name
        if init_std(name, fan) and math.prod(table[name][0]) > 1:
            assert not torch.equal(_leaf(other, name), _leaf(want, name))
