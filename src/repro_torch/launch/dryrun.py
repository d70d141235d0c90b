"""Dry run: plan per-rank memory, FLOPs and collectives of every (arch x
shape x mesh) cell on the production meshes, without allocating
(counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_72b \\
        --shape train_4k --mesh single,multi --device cpu

Each cell runs one step in a process group of the production world (256
ranks on ``single``, 512 on ``multi``) made with the ``fake`` backend,
which moves no data: the production mesh (``launch.mesh``), the state,
batch and cache placed by the port's own ``state_shardings`` /
``batch_shardings`` / ``cache_spec``, and one step of
``make_train_step(mesh=...)`` or ``make_serve_steps(mesh=...)``'s prefill
or decode, on ``DTensor`` s whose local blocks live on the ``meta``
device (shapes, no storage). ``--device`` is the mesh's device type
(``cuda`` by default, ``cpu`` where there is no card). Below ``DTensor``
the step is counted op by op: FLOPs of the local ops (per rank, by
``torch.utils.flop_counter``'s formulas), every collective
(``hlo_analysis.CollectiveRecorder``) and the live bytes of the local
blocks (:class:`StepCounter`). The artifact keeps the reference's keys
(``roofline.summarize_artifacts`` reads it) and adds the keyed init's peak
(:func:`init_peak_per_rank`) and the wire bytes by mesh axis.

There is no compile: ``lower_s`` is the step's dispatch, ``compile_s`` 0.
The port loops over layers in Python, so nothing is counted once per loop
body (``body_multiplier`` 1). :func:`lower_lkgp_cell` plans the paper's own
operator: one application of ``lkgp_dist.dist_lk_operator`` (one CG
iteration; a whole solve reads the device every iteration, which no
``meta`` tensor can answer).

The plan arithmetic that allocates nothing at all is here too:
:func:`init_peak_per_rank` (the keyed init) and
:func:`leafwise_init_peak_per_rank` (the one-stream leaf-by-leaf init it
replaced), :func:`train_state_bytes`, :func:`serve_plan_rows` and
:func:`train_plan_rows`.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import time
import traceback
import types
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..distributed.sharding import (FSDP_RULES, SERVE_DECODE_RULES,
                                    SERVE_RULES, SP_ACT_RULES,
                                    ZERO_ACT_RULES, ZERO_RULES,
                                    block_ranges, cache_spec,
                                    drawn_slab_bytes, logical_to_pspec,
                                    mesh_shape, param_bytes_per_rank,
                                    placed_zeros, rules_for, spec_bytes,
                                    state_shardings, table_shapes)
from ..models import active_params, build_model, count_params
from ..models.registry import make_input_specs
from ..models.transformer import init_std, zero_init
from ..train.optimizers import (OptConfig, init_opt_state, tree_leaves,
                                tree_map)
from .hlo_analysis import CollectiveRecorder, analyze_collectives
from .mesh import make_production_mesh

__all__ = ["MESHES", "WORLDS", "cell_rules", "lower_cell", "plan_cell",
           "plan_layers", "rank_coords",
           "lower_lkgp_cell", "StepCounter", "fake_world",
           "init_peak_per_rank",
           "leafwise_init_peak_per_rank", "train_state_bytes",
           "serve_plan_rows", "train_plan_rows", "plan_serve", "plan_train",
           "main"]

MESHES = {"single": False, "multi": True}
WORLDS = {"single": 256, "multi": 512}   # ranks of each production mesh


def _opt_for(cfg):
    # 400B-class MoE: bf16 moments + adafactor (the reference's rule).
    n = count_params(cfg)
    if n >= 1e11:
        return OptConfig(name="adafactor", moments_dtype=torch.bfloat16)
    return OptConfig(name="adamw")


def _accum_for(cfg, shape):
    """Gradient-accumulation factor for train shapes (the reference's
    rule: <= ~8k tokens per device per microbatch over a 16-wide 'data'
    axis)."""
    if shape.kind != "train":
        return 1
    tokens = shape.global_batch * shape.seq_len
    per_dev = tokens / 16  # batch shards over the 16-wide 'data' axis
    target = 4096 if (cfg.moe and cfg.d_model >= 7000) else 8192
    accum = max(1, int(per_dev // target))
    while shape.global_batch % accum:
        accum -= 1
    return accum


def cell_rules(cfg, shape, profile: str = "optimized") -> dict:
    """The reference's choice of rules for a cell (``lower_cell``'s):
    ``rules`` and ``act_rules`` of a train step, ``serve_rules`` of a serve
    step, and ``grad_accum``. "baseline" serves by the parameter rules;
    "optimized" serves a decode by ``SERVE_DECODE_RULES``, a prefill by
    ``SERVE_RULES`` (MoE) or the parameter rules (dense), and trains a dense
    config of >= 1e10 parameters by ZeRO-DP and an MoE config with
    sequence-parallel layer boundaries."""
    rules = rules_for(cfg)
    act_rules = None
    if profile == "baseline":
        serve_rules = rules
    elif shape.kind == "decode":
        serve_rules = SERVE_DECODE_RULES
    else:
        serve_rules = SERVE_RULES if cfg.moe else rules
    if profile == "optimized" and shape.kind == "train" \
            and not cfg.moe and count_params(cfg) >= 1e10:
        rules, act_rules = ZERO_RULES, ZERO_ACT_RULES
    if profile == "optimized" and shape.kind == "train" and cfg.moe:
        act_rules = SP_ACT_RULES
    grad_accum = _accum_for(cfg, shape)
    if profile == "optimized" and act_rules is ZERO_ACT_RULES:
        grad_accum = 1
    return {"rules": rules, "act_rules": act_rules,
            "serve_rules": serve_rules, "grad_accum": grad_accum}


# --------------------------------------------------------------------------
# plan arithmetic (nothing allocated)
# --------------------------------------------------------------------------
def init_peak_per_rank(table: dict, rules, mesh, dtype,
                       coords: dict | None = None) -> int:
    """The keyed init's peak on the rank at ``coords`` (default: every
    axis 0) of ``mesh`` (a ``DeviceMesh`` or anything whose ``.shape`` maps
    axis -> size), nothing allocated: leaves in ``build_params``' order,
    each leaf's block added to the blocks placed before it, plus the
    largest float32 slab it draws (``sharding.drawn_slab_bytes``; none for
    a zero leaf)."""
    sizes = mesh_shape(mesh)
    coords = coords or {a: 0 for a in sizes}
    size = torch.finfo(dtype).bits // 8
    placed = peak = 0
    for name in sorted(table):
        shape, logical, fan = table[name]
        ranges = block_ranges(shape, logical_to_pspec(logical, rules, mesh,
                                                      shape), sizes, coords)
        block = math.prod(hi - lo for lo, hi in ranges) * size
        slab = 0 if init_std(name, fan) == 0 \
            else drawn_slab_bytes(shape, ranges)
        peak = max(peak, placed + block + slab)
        placed += block
    return peak


def leafwise_init_peak_per_rank(table: dict, rules, mesh, dtype) -> int:
    """The peak of the init this port had before the keyed one (each leaf
    drawn whole on every rank from one sorted-name stream, then placed):
    the blocks placed so far, then a leaf's float32 draw, its cast and its
    block (a norm or bias leaf is made in ``dtype`` directly)."""
    size = torch.finfo(dtype).bits // 8
    placed = peak = 0
    for name in sorted(table):
        shape, logical, fan = table[name]
        n = math.prod(shape)
        block = spec_bytes(shape, logical_to_pspec(logical, rules, mesh,
                                                   shape), mesh, size)
        drawn = n * size + (0 if zero_init(name) else n * 4)
        peak = max(peak, placed + drawn + block)
        placed += block
    return peak


def rank_coords(mesh):
    """Every rank's coordinates (axis -> index) on ``mesh``, in rank
    order."""
    sizes = mesh_shape(mesh)
    return [dict(zip(sizes, c))
            for c in itertools.product(*(range(k) for k in sizes.values()))]


def train_state_bytes(model, mesh, opt: OptConfig, rules) -> dict:
    """Bytes one rank holds of the train state (no allocation): parameters
    and gradients in the parameter dtype, moments in ``opt``'s, each leaf
    by its sharding."""
    sh = state_shardings(model, mesh, rules, opt)
    shapes = table_shapes(model.param_table)
    psize = torch.finfo(model.cfg.dtype_param).bits // 8
    msize = torch.finfo(opt.moments_dtype).bits // 8
    p = sum(spec_bytes(tuple(s), n.spec, mesh, psize)
            for s, n in zip(tree_leaves(shapes), tree_leaves(sh.params)))
    o_shapes = init_opt_state(tree_map(
        lambda s: torch.empty(s, device="meta"), shapes), opt)
    m = sum(spec_bytes(tuple(o.shape), n.spec, mesh, msize)
            for o, n in zip(tree_leaves(o_shapes),
                            tree_leaves(sh.opt_state)))
    return {"params_gb": p / 1e9, "grads_gb": p / 1e9, "moments_gb": m / 1e9,
            "total_gb": (2 * p + m) / 1e9}


def serve_plan_rows(archs, meshes, cache=(8, 2048),
                    card_bytes: float = 80e9) -> list[dict]:
    """Per config and mesh (data, model): the parameter bytes per rank
    under ``SERVE_RULES``, the KV cache bytes per rank at ``cache`` (batch,
    positions) under both cache layouts, the init's peak per rank (the
    keyed one, largest over the ranks, and the leaf-by-leaf one it
    replaced), and the smallest mesh whose parameters and cache fit
    ``card_bytes``. Nothing is allocated."""
    rows = []
    batch, positions = cache
    for arch in archs:
        cfg = get_config(arch)
        model = build_model(cfg)
        size = torch.finfo(cfg.dtype_param).bits // 8
        whole = sum(math.prod(s) for s, _, _ in model.param_table.values())
        row = {"arch": arch, "whole_gb": whole * size / 1e9, "meshes": {}}
        kv_leaves = model.init_cache(batch, positions, device="meta")
        fits = None
        for shape in meshes:
            mesh = types.SimpleNamespace(
                shape={"data": shape[0], "model": shape[1]})
            p = param_bytes_per_rank(model.param_table, SERVE_RULES, mesh,
                                     size)
            kv = {prefer: sum(spec_bytes(
                leaf.shape, cache_spec(leaf.shape, leaf.dtype, mesh, prefer),
                mesh, leaf.element_size()) for leaf in kv_leaves)
                for prefer in ("width", "time")}
            keyed = max(init_peak_per_rank(model.param_table, SERVE_RULES,
                                           mesh, cfg.dtype_param, c)
                        for c in rank_coords(mesh))
            entry = {"param_gb": p / 1e9,
                     "kv_cache_gb": {k: v / 1e9 for k, v in kv.items()},
                     "init_peak_gb": keyed / 1e9,
                     "leafwise_init_peak_gb": leafwise_init_peak_per_rank(
                         model.param_table, SERVE_RULES, mesh,
                         cfg.dtype_param) / 1e9,
                     "fits_card": max(p + max(kv.values()), keyed)
                     <= card_bytes}
            if fits is None and entry["fits_card"]:
                fits = list(shape)
            row["meshes"]["x".join(map(str, shape))] = entry
        row["smallest_fitting_mesh"] = fits
        rows.append(row)
    return rows


def train_plan_rows(archs, worlds=(8, 16, 32, 64),
                    card_bytes: float = 80e9) -> list[dict]:
    """Per config: the train state per rank under ``rules_for`` at
    (world / 8, 8) and (2, world / 16, 8), AdamW with float32 moments and
    Adafactor with bf16 moments, the keyed init's peak per rank, and the
    smallest mesh whose state fits ``card_bytes`` (activations not
    counted). Nothing is allocated."""
    rows = []
    for arch in archs:
        cfg = get_config(arch)
        model = build_model(cfg)
        rules = rules_for(cfg)
        row = {"arch": arch, "params": count_params(cfg),
               "rules": "FSDP_RULES" if rules is FSDP_RULES else "TP_RULES",
               "meshes": {}, "init_peak_gb": {},
               "smallest_fitting_mesh": {}, "activations": "not counted"}
        for opt in (OptConfig(name="adamw"),
                    OptConfig(name="adafactor",
                              moments_dtype=torch.bfloat16)):
            key = f"{opt.name} {str(opt.moments_dtype).split('.')[-1]}"
            fits = None
            for world in worlds:
                shapes = [{"data": world // 8, "model": 8}]
                if world >= 16:
                    shapes.append({"pod": 2, "data": world // 16,
                                   "model": 8})
                for shape in shapes:
                    mesh = types.SimpleNamespace(shape=shape)
                    b = train_state_bytes(model, mesh, opt, rules)
                    name = "x".join(str(v) for v in shape.values())
                    row["meshes"].setdefault(name, {})[key] = b
                    if name not in row["init_peak_gb"]:
                        row["init_peak_gb"][name] = init_peak_per_rank(
                            model.param_table, rules, mesh,
                            cfg.dtype_param) / 1e9
                    if fits is None and b["total_gb"] * 1e9 <= card_bytes:
                        fits = name
            row["smallest_fitting_mesh"][key] = fits
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# one step, counted
# --------------------------------------------------------------------------
class StepCounter(TorchDispatchMode):
    """FLOPs and live bytes of the local ops dispatched inside it.

    ``DTensor`` ops pass through to their local ops, which are counted:
    ``flops`` by ``torch.utils.flop_counter``'s formulas on the local
    shapes (per rank), and every new storage a local op returns is live
    from then until it is freed (``now``, ``peak``; ``hold`` adds tensors
    made before the step, the arguments). Ops run while a fake mode is
    active are not the step's: ``DTensor`` derives an op's global output
    shape on fake tensors the first time it meets the op, and their
    ``meta`` storage of the GLOBAL size would count (a 4k-token train
    step's first layer counted 140 GiB a rank for its 35)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.live: dict[int, int] = {}
        self.now = self.peak = 0

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        self.live[key] = st.nbytes()
        self.now += self.live[key]
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def hold(self, tree) -> int:
        """Track every local block of ``tree`` (nested dicts, tuples,
        lists, named tuples of tensors); returns their bytes."""
        before = self.now
        for t in _tensors(tree):
            self._track(_local(t))
        return self.now - before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(t == DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) \
                is not None or any(t not in (torch.Tensor, torch.nn.Parameter)
                                   for t in types):
            # DTensor deriving an op's global shape on fake tensors (of
            # the global size, on first meeting the op): not the step's
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        for t in _tensors(out):
            self._track(t)
        return out


def _local(t):
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@contextlib.contextmanager
def fake_world(world: int):
    """A process group of ``world`` ranks, this process rank 0, on the
    ``fake`` backend (no data moves; collectives complete at once)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs its own process group; one "
                           "is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta_tree(shardings, shapes, dtype):
    if isinstance(shardings, dict):
        return {k: _meta_tree(shardings[k], shapes[k], dtype)
                for k in shardings}
    return placed_zeros(tuple(shapes), dtype, shardings, "meta")


def _counted(fn, mesh, arguments):
    """Run ``fn()`` under the counters with ``arguments`` held: (its
    output, the arguments' bytes, the :class:`StepCounter`, the collective
    records, seconds)."""
    counter = StepCounter()
    recorder = CollectiveRecorder(mesh)
    t0 = time.perf_counter()
    with counter:
        args = counter.hold(arguments)
        with recorder:
            out = fn()
    seconds = time.perf_counter() - t0
    return out, args, counter, recorder.records, seconds


def _artifact(args: int, counter, out, records, n_dev: int,
              seconds: float, arguments) -> dict:
    """The reference's cost, memory and collective keys of a counted
    step."""
    arg_keys = {_local(t).untyped_storage()._cdata
                for t in _tensors(arguments)}
    out_bytes = alias = 0
    seen = set()
    for t in _tensors(out):
        st = _local(t).untyped_storage()
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        out_bytes += st.nbytes()
        alias += st.nbytes() if st._cdata in arg_keys else 0
    stats = analyze_collectives(records, n_dev)
    return {
        "lower_s": round(seconds, 2), "compile_s": 0.0,
        "cost_analysis": {
            "flops_per_device": float(counter.flops),
            "bytes_accessed_per_device": -1.0,
        },
        "memory_analysis": {
            "argument_bytes_per_device": args,
            "output_bytes_per_device": out_bytes,
            "temp_bytes_per_device": counter.peak - args,
            "alias_bytes_per_device": alias,
            "generated_code_bytes": 0,
            "peak_bytes_per_device": counter.peak,
        },
        "collectives": {
            "raw": {k: dict(count=v[0], result_bytes=v[1], wire_bytes=v[2])
                    for k, v in stats.entry.items()},
            "in_loop_bodies": {},
            "body_multiplier": 1,
            "totals": stats.totals(1),
            "total_wire_bytes_per_device": stats.total_wire_bytes(1),
            "wire_bytes_per_device_by_axis": dict(stats.axes),
        },
    }


def _meta_batch(specs: dict) -> dict:
    return {k: torch.zeros(v.shape, dtype=v.dtype, device="meta")
            for k, v in specs.items()}


def plan_train(cfg, batch: int, seq: int, mesh, opt: OptConfig,
               grad_accum: int = 1, rules=None, act_rules=None,
               donate: bool = True) -> dict:
    """One donated train step of ``cfg`` at ``batch`` x ``seq`` on
    ``mesh`` (a ``DeviceMesh`` over a fake group), counted: the artifact
    without its head. The state is each rank's ``meta`` blocks laid out by
    ``state_shardings``, the batch placed by ``batch_shardings``."""
    from ..train.trainer import TrainState, _place_batch, make_train_step

    model = build_model(cfg)
    rules = rules if rules is not None else rules_for(cfg)
    setup = make_train_step(model, opt, grad_accum, "meta", donate=donate,
                            mesh=mesh, rules=rules, act_rules=act_rules)
    sh = setup.state_shardings
    params = _meta_tree(sh.params, table_shapes(model.param_table),
                        cfg.dtype_param)
    state = TrainState(params=params,
                       opt_state=init_opt_state(params, opt, sh.opt_state),
                       step=torch.zeros((), dtype=torch.int32,
                                        device="meta"))
    shape = types.SimpleNamespace(global_batch=batch, seq_len=seq,
                                  kind="train")
    data = _place_batch(_meta_batch(make_input_specs(cfg, shape)), mesh,
                        torch.device("meta"))
    arguments = (state, data)
    out, args, counter, records, seconds = _counted(
        lambda: setup.step_fn(state, data), mesh, arguments)
    return _artifact(args, counter, out, records, mesh.size(), seconds,
                     arguments)


def plan_serve(cfg, batch: int, seq: int, mesh, kind: str, rules=None,
               max_len: int | None = None) -> dict:
    """One ``kind`` ("prefill" or "decode") serve step of ``cfg`` on
    ``mesh`` counted, the parameters each rank's ``meta`` blocks by
    ``rules`` (default ``SERVE_RULES``): a prefill of ``batch`` x ``seq``
    tokens into a cache of ``max_len`` (default ``seq``) positions, or one
    decode token against a cache of ``seq`` positions. The cache is in the
    layout the port's decode writes (``prefer="width"``, the prefill's):
    the reference plans its decode cells in ``"time"``, which shards the
    axis a decode step writes, and the port's cache write refuses that."""
    from ..train.trainer import _place_batch, make_serve_steps

    model = build_model(cfg)
    max_len = max_len or seq
    steps = make_serve_steps(model, max_len, "meta", mesh=mesh, rules=rules)
    params = _meta_tree(steps["param_shardings"],
                        table_shapes(model.param_table), cfg.dtype_param)
    shape = types.SimpleNamespace(global_batch=batch, seq_len=seq, kind=kind)
    data = _place_batch(_meta_batch(make_input_specs(cfg, shape)), mesh,
                        torch.device("meta"))
    # the cache layout is worked out (on meta tensors of the whole cache)
    # before the step, as a running server has it
    layout = steps["cache_shardings"](batch, "width")
    if kind == "prefill":
        arguments = (params, data)
        out, args, counter, records, seconds = _counted(
            lambda: steps["prefill"](params, data), mesh, arguments)
    else:
        shapes = model.init_cache(batch, max_len, device="meta")
        cache = type(shapes)(*(
            placed_zeros(tuple(leaf.shape), leaf.dtype, sh, "meta")
            if leaf.ndim >= 2 else leaf for leaf, sh in zip(shapes, layout)))
        arguments = (params, cache, data)
        out, args, counter, records, seconds = _counted(
            lambda: steps["decode_step"](params, cache, data["tokens"]),
            mesh, arguments)
    return _artifact(args, counter, out, records, mesh.size(), seconds,
                     arguments)


def _period(cfg) -> int:
    """Layers after which the stack repeats itself: the hybrid's block
    pattern, the cycle of per-layer windows, else one."""
    if cfg.family == "hybrid" and cfg.block_pattern:
        return len(cfg.block_pattern)
    return len(cfg.layer_windows) if cfg.layer_windows else 1


def _extrapolate(one: dict, two: dict, mult: float) -> dict:
    """The artifact of the whole depth from those of one period (``one``)
    and two (``two``): every count is linear in the periods, so the whole
    is ``one + mult * (two - one)``. The collectives keep the reference's
    split: ``raw`` the first period's, ``in_loop_bodies`` a period's."""
    def lin(a, b):
        return a + mult * (b - a)
    ma, mb = one["memory_analysis"], two["memory_analysis"]
    mem = {k: lin(ma[k], mb[k]) for k in ma}
    mem["temp_bytes_per_device"] = mem["peak_bytes_per_device"] \
        - mem["argument_bytes_per_device"]
    ca, cb = one["collectives"], two["collectives"]
    body = {}
    for kind in set(ca["raw"]) | set(cb["raw"]):
        ea = ca["raw"].get(kind, dict(count=0, result_bytes=0, wire_bytes=0))
        eb = cb["raw"].get(kind, dict(count=0, result_bytes=0, wire_bytes=0))
        body[kind] = {k: eb[k] - ea[k] for k in ea}
    totals = {kind: {k: ca["raw"].get(kind, {}).get(k, 0) + mult * b[k]
                     for k in b} for kind, b in body.items()}
    axes = {a: lin(ca["wire_bytes_per_device_by_axis"].get(a, 0.0),
                   cb["wire_bytes_per_device_by_axis"].get(a, 0.0))
            for a in set(ca["wire_bytes_per_device_by_axis"])
            | set(cb["wire_bytes_per_device_by_axis"])}
    return {
        "lower_s": one["lower_s"] + two["lower_s"], "compile_s": 0.0,
        "cost_analysis": {
            "flops_per_device": lin(one["cost_analysis"]["flops_per_device"],
                                    two["cost_analysis"]["flops_per_device"]),
            "bytes_accessed_per_device": -1.0},
        "memory_analysis": mem,
        "collectives": {
            "raw": ca["raw"], "in_loop_bodies": body,
            "body_multiplier": mult, "totals": totals,
            "total_wire_bytes_per_device": sum(v["wire_bytes"]
                                               for v in totals.values()),
            "wire_bytes_per_device_by_axis": axes},
    }


def plan_layers(cfg, plan, whole: bool = False):
    """``plan(cfg)``'s artifact and the depths dispatched: at the whole
    depth when ``whole`` or when it is at most two periods
    (:func:`_period`), else extrapolated from one period and two
    (:func:`_extrapolate`)."""
    period = _period(cfg)
    depth = cfg.num_layers
    if whole or depth <= 2 * period:
        return plan(cfg), [depth]
    return _extrapolate(plan(cfg.replace(num_layers=period)),
                        plan(cfg.replace(num_layers=2 * period)),
                        (depth - period) / period), [period, 2 * period]


def plan_cell(arch: str, shape, mesh, mesh_name: str,
              profile: str = "optimized", rules=None) -> dict:
    """Plan one cell, ``shape`` any ``ShapeSpec`` (name, seq_len,
    global_batch, kind), on ``mesh`` (a ``DeviceMesh`` over a fake group);
    returns the artifact dict. ``rules``, when given, replaces the
    profile's parameter rules (the serve rules of a serve cell).

    The rules are the reference's per profile (:func:`cell_rules`). The
    port's serve steps always make their mesh active, so "baseline" keeps
    the expert-parallel MoE where the reference falls back to its einsum
    dispatch. A train step's gradient accumulation is the reference's
    factor, or the largest divisor of it that divides each rank's rows of
    the batch (the port accumulates over each rank's block); both are
    recorded.

    The port loops over layers in Python and ``DTensor`` dispatches every
    op of every layer on the host (a 32k-token prefill takes about a
    minute a layer on a CPU), so the step is dispatched at one period of
    layers and at two and the whole depth is their linear extrapolation
    (:func:`plan_layers`): the reference's split of loop body and
    multiplier, with the body measured. The init's peak comes from the
    whole table."""
    cfg = get_config(arch)
    choice = cell_rules(cfg, shape, profile)
    sizes = mesh_shape(mesh)
    accum = choice["grad_accum"]
    if shape.kind == "train":
        dp = math.prod(sizes.get(a, 1) for a in ("pod", "data")
                       if shape.global_batch % sizes.get(a, 1) == 0)
        rows = shape.global_batch // dp
        while rows % accum:
            accum -= 1
        init_rules = rules if rules is not None else choice["rules"]

        def plan(c):
            return plan_train(c, shape.global_batch, shape.seq_len, mesh,
                              _opt_for(cfg), accum, init_rules,
                              choice["act_rules"])
    else:
        init_rules = rules if rules is not None else choice["serve_rules"]

        def plan(c):
            return plan_serve(c, shape.global_batch, shape.seq_len, mesh,
                              shape.kind, init_rules)
    art, dispatched = plan_layers(cfg, plan)
    head = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
            "shape_spec": {"name": shape.name, "seq_len": shape.seq_len,
                           "global_batch": shape.global_batch,
                           "kind": shape.kind},
            "mesh_shape": sizes, "num_devices": int(mesh.size()),
            "profile": profile, "params": count_params(cfg),
            "active_params": active_params(cfg), "grad_accum": accum,
            "grad_accum_reference": choice["grad_accum"],
            "layers": cfg.num_layers, "layers_dispatched": dispatched,
            "init_peak_bytes_per_rank": init_peak_per_rank(
                build_model(cfg).param_table, init_rules, mesh,
                cfg.dtype_param),
            "loop_body_note":
                "layers are a Python loop, so every dispatched layer's "
                "collectives are recorded (multiplier 1 within a run); "
                "depths beyond two periods are extrapolated from one "
                "period and two (body_multiplier)"}
    return {**head, **art}


def lower_cell(arch: str, shape_name: str, mesh, mesh_name: str,
               profile: str = "optimized") -> dict:
    """Plan the cell (``arch``, ``SHAPES[shape_name]``) on ``mesh``
    (:func:`plan_cell`); returns the artifact dict."""
    return plan_cell(arch, SHAPES[shape_name], mesh, mesh_name, profile)


def lower_lkgp_cell(mesh, mesh_name: str, n: int = 8192, m: int = 100,
                    d: int = 16, dtype=torch.float32) -> dict:
    """The paper's own operator on the production mesh: one application
    of ``lkgp_dist.dist_lk_operator`` (one CG iteration's MVM), rows of
    the grid over every rank of the group, K2 replicated. ``d`` sizes the
    inputs X the argument bytes count (K1's row block is built from them
    before the solve)."""
    from ..distributed.lkgp_dist import dist_lk_operator

    chips = mesh.size()
    n_local = n // chips
    K1 = torch.zeros((n_local, n), dtype=dtype, device="meta")
    K2 = torch.zeros((m, m), dtype=dtype, device="meta")
    mask = torch.zeros((n_local, m), dtype=dtype, device="meta")
    X = torch.zeros((n_local, d), dtype=dtype, device="meta")
    u = torch.zeros((n_local, m), dtype=dtype, device="meta")
    noise = torch.zeros((), dtype=dtype, device="meta")
    arguments = (K1, K2, mask, X, u, noise)
    A = dist_lk_operator(K1, K2, mask, noise, dist.group.WORLD)
    out, args, counter, records, seconds = _counted(
        lambda: A(u), mesh, arguments)
    itemsize = torch.finfo(dtype).bits // 8
    art = _artifact(args, counter, out, records, chips, seconds,
                    arguments)
    return {
        "arch": "lkgp", "shape": f"fit_n{n}_m{m}", "mesh": mesh_name,
        "mesh_shape": mesh_shape(mesh), "num_devices": chips, "params": 0,
        "active_params": 0, "grad_accum": 1,
        "unit": "one CG iteration: one dist_lk_operator application, "
                "rows over every rank",
        "analytic_per_cg_iter": {
            "flops_per_chip": (2 * n * n * m + 2 * n * m * m) / chips,
            "allgather_bytes_per_chip": n * m * itemsize * (chips - 1)
            / chips,
        },
        **art,
    }


def _mesh_for(mesh_name: str, device: str):
    return make_production_mesh(multi_pod=MESHES[mesh_name],
                                device_type=device)


def _run_cell(args, arch, shape_name, mesh_name):
    with fake_world(WORLDS[mesh_name]):
        mesh = _mesh_for(mesh_name, args.device)
        if arch == "lkgp":
            return lower_lkgp_cell(mesh, mesh_name)
        return lower_cell(arch, shape_name, mesh, mesh_name,
                          profile=args.profile)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help="comma list or 'all'; 'lkgp' is the paper's "
                    "operator")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--profile", default="optimized",
                    choices=["baseline", "optimized"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the mesh's device type (tensors are 'meta')")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--fail-fast", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")
    os.makedirs(args.out, exist_ok=True)

    results = []
    for mesh_name in meshes:
        for arch in archs:
            cells = [("fit", f"lkgp__fit__{mesh_name}.json")] \
                if arch == "lkgp" else \
                [(s, f"{arch}__{s}__{mesh_name}.json") for s in shapes]
            for shape_name, fname in cells:
                if arch != "lkgp" and not shape_applicable(arch, shape_name):
                    print(f"SKIP  {arch:24s} {shape_name:12s} {mesh_name}"
                          " (inapplicable: full attention at 500k)")
                    continue
                path = os.path.join(args.out, fname)
                if args.skip_existing and os.path.exists(path):
                    print(f"HAVE  {arch:24s} {shape_name:12s} {mesh_name}")
                    continue
                try:
                    art = _run_cell(args, arch, shape_name, mesh_name)
                    with open(path, "w") as f:
                        json.dump(art, f, indent=1)
                    ma = art["memory_analysis"]
                    args_gib = ma["argument_bytes_per_device"] / 2 ** 30
                    temp_gib = ma["temp_bytes_per_device"] / 2 ** 30
                    flops = art["cost_analysis"]["flops_per_device"]
                    print(f"OK    {arch:24s} {shape_name:12s} {mesh_name:6s} "
                          f"lower={art['lower_s']:7.1f}s "
                          f"args/dev={args_gib:6.2f}GiB "
                          f"temp/dev={temp_gib:6.2f}GiB "
                          f"flops/dev={flops:.3e}", flush=True)
                    results.append((arch, shape_name, mesh_name, "OK"))
                except Exception as e:  # noqa: BLE001 - report and continue
                    print(f"FAIL  {arch:24s} {shape_name:12s} {mesh_name}: "
                          f"{type(e).__name__}: {e}", flush=True)
                    traceback.print_exc()
                    results.append((arch, shape_name, mesh_name, "FAIL"))
                    if args.fail_fast:
                        raise
    ok = sum(1 for r in results if r[-1] == "OK")
    print(f"\ndry-run: {ok}/{len(results)} cells planned")
    if any(r[-1] == "FAIL" for r in results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
