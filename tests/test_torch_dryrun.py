"""PyTorch port, the dry run (``launch/dryrun.py``) and its collective
accounting (``launch/hlo_analysis.py``) on the CPU, held against
``repro.launch.dryrun`` / ``repro.launch.hlo_analysis``:

* ``_opt_for``, ``_accum_for`` and the choice of rules of every arch x
  shape x profile equal the reference's (its ``lower_cell`` run up to the
  step it would build, in a subprocess: its module sets the XLA
  device-count flag);
* on a smoke config at a (2, 2) mesh the port's per-rank argument bytes
  equal the reference's ``compiled.memory_analysis()
  .argument_size_in_bytes`` (4 host devices, the same subprocess);
* ``_wire_bytes`` and ``CollectiveStats`` equal the reference's on a
  table of kinds, sizes and group sizes; the recorder on a fake-group
  program with known collectives gives the hand-computed bytes per axis;
* the CLI writes the reference's artifact layout, and the depth
  extrapolation equals dispatching every layer.

The ranks are a ``fake`` process group in this process (no data moves).
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import pytest
import torch
import torch.distributed as dist

from repro.launch import hlo_analysis as ref_hlo
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.distributed.sharding import rules_for
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_debug_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = dict(arch="stablelm_12b", batch=4, seq=32)     # smoke, at (2, 2)

REFERENCE = r"""
import json, sys
import jax
jax.devices()   # 4 host devices, before the dry run's module sets its flag
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro.configs.base import ShapeSpec
from repro.distributed import sharding as sh
from repro.launch import dryrun
from repro.launch.mesh import make_debug_mesh
from repro.models import build_model, make_input_specs
from repro.train.trainer import make_serve_steps

cell = json.loads(sys.argv[1])
named = {n: getattr(sh, n) for n in ("TP_RULES", "FSDP_RULES", "ZERO_RULES",
         "SERVE_RULES", "SERVE_DECODE_RULES", "ACT_RULES", "ZERO_ACT_RULES",
         "SP_ACT_RULES")}

def name_of(rules):
    if rules is None:
        return None
    return [n for n, r in named.items() if r is rules or r == rules][0]

class Built(Exception):
    pass

seen = {}
def train_step(model, mesh, opt_cfg=None, rules=None, act_rules=None,
               grad_accum=1):
    seen.update(rules=name_of(rules), act_rules=name_of(act_rules),
                grad_accum=grad_accum)
    raise Built
def serve_steps(model, mesh, rules=None, max_len=2048):
    seen.update(rules=name_of(rules))
    raise Built
dryrun.make_train_step, dryrun.make_serve_steps = train_step, serve_steps

out = {"cells": {}}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    opt = dryrun._opt_for(cfg)
    for shape in SHAPES:
        for profile in ("baseline", "optimized"):
            seen.clear()
            try:
                dryrun.lower_cell(arch, shape, None, "single", profile)
            except Built:
                pass
            out["cells"][f"{arch}/{shape}/{profile}"] = dict(
                seen, opt=[opt.name, jnp.dtype(opt.moments_dtype).name],
                accum=dryrun._accum_for(cfg, SHAPES[shape]))

# argument bytes of a smoke prefill and decode at (data 2, model 2)
mesh = make_debug_mesh(2, 2)
cfg = get_smoke_config(cell["arch"])
model = build_model(cfg)
rules = sh.rules_for(cfg)
B, S = cell["batch"], cell["seq"]
serve = make_serve_steps(model, mesh, rules=rules, max_len=S)
p_shapes = jax.eval_shape(lambda k: model.init(k), jax.random.key(0))
p_in = jax.tree_util.tree_map(
    lambda s, h: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=h),
    p_shapes, serve["param_shardings"])
vocab_ok = cfg.vocab_size % mesh.shape.get("model", 1) == 0
logits_sh = NamedSharding(mesh, P(None, "model" if vocab_ok else None))
specs = make_input_specs(cfg, ShapeSpec("x", S, B, "prefill"))
bsh = sh.batch_shardings(specs, mesh)
batch_in = {k: jax.ShapeDtypeStruct(v.shape, v.dtype, sharding=bsh[k])
            for k, v in specs.items()}
cache_sh = serve["cache_shardings"](B, prefer="width")
fn = jax.jit(serve["prefill"], in_shardings=(serve["param_shardings"],
             {k: v.sharding for k, v in batch_in.items()}),
             out_shardings=(logits_sh, cache_sh))
with mesh:
    mem = fn.lower(p_in, batch_in).compile().memory_analysis()
out["prefill_argument_bytes"] = int(mem.argument_size_in_bytes)
cache_shapes = jax.eval_shape(lambda: model.init_cache(B, S))
cache_in = jax.tree_util.tree_map(
    lambda s, h: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=h),
    cache_shapes, cache_sh)
specs = make_input_specs(cfg, ShapeSpec("x", S, B, "decode"))
bsh = sh.batch_shardings(specs, mesh)
tok = jax.ShapeDtypeStruct(specs["tokens"].shape, specs["tokens"].dtype,
                           sharding=bsh["tokens"])
fn = jax.jit(serve["decode_step"], out_shardings=(logits_sh, cache_sh))
with mesh:
    mem = fn.lower(p_in, cache_in, tok).compile().memory_analysis()
out["decode_argument_bytes"] = int(mem.argument_size_in_bytes)
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        json.dumps(CELL)], capture_output=True, text=True,
                       timeout=400, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _name(rules):
    from repro_torch.distributed import sharding as sh
    if rules is None:
        return None
    return [n for n in ("TP_RULES", "FSDP_RULES", "ZERO_RULES",
                        "SERVE_RULES", "SERVE_DECODE_RULES", "ACT_RULES",
                        "ZERO_ACT_RULES", "SP_ACT_RULES")
            if getattr(sh, n) is rules][0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_accum_and_rules_equal_the_reference(reference, arch):
    """Every shape and profile: the optimizer and its moments' dtype, the
    accumulation factor, and the rule sets a train step (parameters,
    activations, accumulation) or a serve step would be built with."""
    cfg = get_config(arch)
    opt = dryrun._opt_for(cfg)
    for shape in SHAPES:
        for profile in ("baseline", "optimized"):
            want = reference["cells"][f"{arch}/{shape}/{profile}"]
            spec = SHAPES[shape]
            assert [opt.name, str(opt.moments_dtype).split(".")[-1]] == \
                want["opt"], (shape, want)
            assert dryrun._accum_for(cfg, spec) == want["accum"]
            got = dryrun.cell_rules(cfg, spec, profile)
            if spec.kind == "train":
                assert _name(got["rules"]) == want["rules"], (shape, profile)
                assert _name(got["act_rules"]) == want["act_rules"]
                assert got["grad_accum"] == want["grad_accum"]
            else:
                assert _name(got["serve_rules"]) == want["rules"], \
                    (shape, profile)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_argument_bytes_equal_the_references(reference, kind):
    """The smoke stablelm_12b at (data 2, model 2): parameters, batch (and
    cache) one rank holds, against the reference's compiled program's
    argument bytes per device."""
    cfg = get_smoke_config(CELL["arch"])
    with dryrun.fake_world(4):
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        art = dryrun.plan_serve(cfg, CELL["batch"], CELL["seq"], mesh, kind,
                                rules_for(cfg))
    assert art["memory_analysis"]["argument_bytes_per_device"] == \
        reference[f"{kind}_argument_bytes"]


KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "other")


def test_wire_bytes_and_stats_equal_the_references():
    for kind in KINDS:
        for size in (0, 1, 4096, 123457):
            for p in (1, 2, 8, 16, 256):
                assert hlo_analysis._wire_bytes(kind, size, p) == \
                    ref_hlo._wire_bytes(kind, size, p), (kind, size, p)
    ours, ref = hlo_analysis.CollectiveStats(), ref_hlo.CollectiveStats()
    for i, kind in enumerate(KINDS[:5]):
        for stats in (ours, ref):
            stats.entry[kind][0] += i + 1
            stats.entry[kind][1] += 1000 * (i + 1)
            stats.entry[kind][2] += 750.5 * (i + 1)
            stats.body[kind][0] += 2
            stats.body[kind][1] += 64 * i
            stats.body[kind][2] += 48.25 * i
    for mult in (1.0, 3.0, 79.0):
        assert ours.totals(mult) == ref.totals(mult)
        assert ours.total_wire_bytes(mult) == ref.total_wire_bytes(mult)


def test_recorder_counts_known_collectives_by_axis():
    """On a (data 2, model 8) mesh of a fake group of 16: an all-reduce of
    a (4, 8) float32 over 'model', an all-gather of it over 'data', and a
    DTensor's all-gather and reduce-scatter over 'model', with the
    reference's ring factors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    with dryrun.fake_world(16):
        mesh = make_debug_mesh(2, 8, device_type="cpu")
        x = torch.zeros(4, 8, device="meta")
        out = torch.empty(8, 8, device="meta")
        blk = torch.zeros(8, 16, device="meta")     # (64, 16) over 'model'
        with hlo_analysis.CollectiveRecorder(mesh) as rec:
            dist.all_reduce(x, group=mesh.get_group("model"))
            dist.all_gather_into_tensor(out, x, group=mesh.get_group("data"))
            a = DTensor.from_local(blk, mesh, (Replicate(), Shard(0)),
                                   run_check=False)
            a.redistribute(mesh, (Replicate(), Replicate()))
            full = torch.zeros(64, 16, device="meta")
            b = DTensor.from_local(full, mesh, (Replicate(), Partial()),
                                   run_check=False)
            b.redistribute(mesh, (Replicate(), Shard(0)))
    stats = hlo_analysis.analyze_collectives(rec.records, 16)
    tot = stats.totals()
    assert tot["all-reduce"] == {"count": 1, "result_bytes": 128,
                                 "wire_bytes": 2 * 128 * 7 / 8}
    assert tot["all-gather"] == {"count": 2, "result_bytes": 256 + 4096,
                                 "wire_bytes": 256 / 2 + 4096 * 7 / 8}
    assert tot["reduce-scatter"] == {"count": 1, "result_bytes": 512,
                                     "wire_bytes": 512 * 7 / 8 * 8}
    assert dict(stats.axes) == {
        "model": 224 + 3584 + 3584, "data": 128}


def test_cli_writes_the_reference_layout(tmp_path):
    """``lkgp`` on both production meshes and one model cell: the
    reference's keys, the operator's FLOPs per rank equal to the analytic
    per-CG-iteration count, its all-gather over every rank."""
    dryrun.main(["--device", "cpu", "--arch", "lkgp,whisper_tiny",
                 "--shape", "decode_32k", "--mesh", "single,multi",
                 "--out", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["lkgp__fit__multi.json", "lkgp__fit__single.json",
                     "whisper_tiny__decode_32k__multi.json",
                     "whisper_tiny__decode_32k__single.json"]
    keys = {"arch", "shape", "mesh", "num_devices", "params",
            "active_params", "grad_accum", "lower_s", "compile_s",
            "cost_analysis", "memory_analysis", "collectives"}
    for name in names:
        art = json.loads((tmp_path / name).read_text())
        assert keys <= set(art), name
        assert {"flops_per_device", "bytes_accessed_per_device"} <= \
            set(art["cost_analysis"])
        assert {"argument_bytes_per_device", "output_bytes_per_device",
                "temp_bytes_per_device", "alias_bytes_per_device",
                "generated_code_bytes"} <= set(art["memory_analysis"])
        assert {"raw", "in_loop_bodies", "body_multiplier", "totals",
                "total_wire_bytes_per_device"} <= set(art["collectives"])
        assert art["num_devices"] == dryrun.WORLDS[art["mesh"]]
    for mesh in ("single", "multi"):
        art = json.loads((tmp_path / f"lkgp__fit__{mesh}.json").read_text())
        ana = art["analytic_per_cg_iter"]
        assert art["cost_analysis"]["flops_per_device"] == \
            ana["flops_per_chip"]
        gather = art["collectives"]["totals"]["all-gather"]
        assert gather["count"] == 1
        assert gather["wire_bytes"] == pytest.approx(
            ana["allgather_bytes_per_chip"])


def test_extrapolated_depth_equals_every_layer():
    """whisper_tiny's decode (4 decoder layers) on the single production
    mesh: extrapolated from 1 and 2 layers against all 4 dispatched: FLOPs,
    argument bytes, collectives and the peak."""
    cfg = get_config("whisper_tiny")
    spec = SHAPES["decode_32k"]
    with dryrun.fake_world(256):
        mesh = dryrun._mesh_for("single", "cpu")

        def plan(c):
            return dryrun.plan_serve(c, spec.global_batch, spec.seq_len,
                                     mesh, "decode")
        cut, cut_layers = dryrun.plan_layers(cfg, plan)
        whole, whole_layers = dryrun.plan_layers(cfg, plan, whole=True)
    assert (cut_layers, whole_layers) == ([1, 2], [4])
    assert cut["cost_analysis"] == pytest.approx(whole["cost_analysis"])
    for k in ("argument_bytes_per_device", "peak_bytes_per_device",
              "output_bytes_per_device"):
        assert cut["memory_analysis"][k] == pytest.approx(
            whole["memory_analysis"][k]), k
    for kind, row in whole["collectives"]["totals"].items():
        assert cut["collectives"]["totals"][kind] == pytest.approx(row)
    assert cut["collectives"]["wire_bytes_per_device_by_axis"] == \
        pytest.approx(whole["collectives"]["wire_bytes_per_device_by_axis"])


def test_plan_rows_keyed_peak_fits_where_the_leafwise_did_not():
    """The serve plan of the three big configs (nothing allocated): the
    keyed init's peak per rank is the blocks plus one slab, under one
    card at each config's fitting mesh, where the leaf-by-leaf init it
    replaced needed 124-1172 GB."""
    rows = dryrun.serve_plan_rows(("qwen2_72b", "qwen3_moe_235b",
                                   "arctic_480b"), ((1, 4), (1, 8), (2, 8)))
    fits = {r["arch"]: r["smallest_fitting_mesh"] for r in rows}
    assert fits == {"qwen2_72b": [1, 4], "qwen3_moe_235b": [1, 8],
                    "arctic_480b": [2, 8]}
    for r in rows:
        for entry in r["meshes"].values():
            assert entry["param_gb"] < entry["init_peak_gb"] \
                <= entry["param_gb"] + 0.07
            assert entry["leafwise_init_peak_gb"] > 120
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 8})
    table = dryrun.build_model(get_config("arctic_480b")).param_table
    peaks = {dryrun.init_peak_per_rank(table, dryrun.SERVE_RULES, mesh,
                                       torch.bfloat16, c)
             for c in dryrun.rank_coords(mesh)}
    assert max(peaks) < 80e9


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_heads_fewer_than_the_model_axis(kind):
    """The smoke qwen3_moe_235b (4 query heads, 2 KV heads) on a (1, 8)
    mesh of a fake group of 8: the fused head dimensions split over 8
    ranks, more than they hold heads. DTensor cannot view such a split as
    heads, so the models replicate it first (``layers.unflattenable``) and
    the step runs through, the MoE on its expert-parallel path."""
    cfg = get_smoke_config("qwen3_moe_235b")
    with dryrun.fake_world(8):
        mesh = make_debug_mesh(1, 8, device_type="cpu")
        if kind == "train":
            art = dryrun.plan_train(cfg, 8, 16, mesh,
                                    dryrun.OptConfig(name="adamw"))
        else:
            art = dryrun.plan_serve(cfg, 8, 16, mesh, kind)
    assert art["cost_analysis"]["flops_per_device"] > 0
    assert art["collectives"]["totals"]


def test_rwkv_decode_with_the_lora_split_unevenly():
    """RWKV-6's decode (one layer at published width) by
    ``SERVE_DECODE_RULES`` on the single production mesh: d_model split
    over 'model' leaves the LoRA's (5 x 32) output split over 8 ranks (20
    each), which cannot be viewed as its 5 mixes until the split is
    replicated (``layers.unflattenable`` in ``rwkv._ddlerp``; the sweep's
    decode cell stopped there)."""
    cfg = get_config("rwkv6_1b6").replace(num_layers=1)
    with dryrun.fake_world(256):
        mesh = dryrun._mesh_for("single", "cpu")
        art = dryrun.plan_serve(cfg, 128, 64, mesh, "decode",
                                dryrun.SERVE_DECODE_RULES)
    assert art["cost_analysis"]["flops_per_device"] > 0


def test_vocab_split_decode_gathers_no_table(monkeypatch):
    """A smoke decode cell on a fake (2, 2) with the embedding's vocab split
    over 'model' (vocab 256, which 'model' divides): no collective of the
    step is the table's size or larger. The lookup works on each rank's
    block and sums the rows over 'model' (``layers.embed_lookup``); before
    it DTensor all-gathered the table every step (5.06 GB a rank at
    qwen2_72b's (32, 8) decode)."""
    from repro_torch.distributed.sharding import logical_to_pspec

    cfg = get_smoke_config("stablelm_12b").replace(vocab_size=256)
    seen = []

    class Recorder(hlo_analysis.CollectiveRecorder):
        def __init__(self, mesh=None):
            super().__init__(mesh)
            seen.append(self)

    monkeypatch.setattr(dryrun, "CollectiveRecorder", Recorder)
    with dryrun.fake_world(4):
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        art = dryrun.plan_serve(cfg, 4, 16, mesh, "decode",
                                dryrun.SERVE_RULES, 32)
        spec = logical_to_pspec(("vocab", "embed"), dryrun.SERVE_RULES,
                                mesh, (cfg.vocab_size, cfg.d_model))
    assert spec[0] == "model"                        # the vocab is split
    table = cfg.vocab_size * cfg.d_model \
        * torch.empty((), dtype=cfg.dtype_param).element_size()
    sizes = [r.result_bytes for rec in seen for r in rec.records]
    assert sizes and art["collectives"]["totals"]
    assert max(sizes) < table, (max(sizes), table)
