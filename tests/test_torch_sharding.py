"""PyTorch port, the logical-axis sharding rules (``repro_torch.distributed.
sharding``), held against ``repro.distributed.sharding`` without a process
group: both resolvers read only ``mesh.shape``, so specs of meshes no machine
here can build ((16, 16), (2, 16, 16)) are compared all the same. The cache
layouts are held against the reference's ``make_serve_steps`` on host
meshes in a subprocess (the XLA device-count flag must be set before JAX
starts). Everything compared here is exact: specs, byte counts, dicts.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest
import torch

import repro.configs as ref_configs
import repro.distributed.sharding as ref_sh
import repro.models as ref_models
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.models import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("whisper_tiny", "recurrentgemma_2b", "arctic_480b",
         "qwen3_moe_235b", "stablelm_12b", "nemotron4_15b",
         "phi3_medium_14b", "qwen2_72b", "llava_next_mistral_7b",
         "rwkv6_1b6")
RULE_SETS = ("TP_RULES", "FSDP_RULES", "ZERO_RULES", "ZERO_ACT_RULES",
             "SERVE_RULES", "SERVE_DECODE_RULES", "ACT_RULES",
             "SP_ACT_RULES")
MESHES = ({"data": 1, "model": 1}, {"data": 2, "model": 2},
          {"data": 1, "model": 8}, {"data": 2, "model": 4},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})
# One config of each family, for the cache layouts.
FAMILY_ARCHS = ("stablelm_12b", "llava_next_mistral_7b", "qwen3_moe_235b",
                "recurrentgemma_2b", "rwkv6_1b6", "whisper_tiny")


def _mesh(shape: dict):
    return SimpleNamespace(shape=dict(shape))


def _leaves(table):
    """(name, shape, logical) of every entry of a parameter table."""
    return [(name, tuple(shape), logical)
            for name, (shape, logical, _) in sorted(table.items())]


@pytest.mark.parametrize("name", RULE_SETS)
def test_rule_dicts_equal_the_reference(name):
    assert getattr(sh, name) == getattr(ref_sh, name)


def test_exports_the_reference_names():
    import repro_torch.distributed as port_dist
    for name in ref_sh.__all__:
        assert hasattr(port_dist, name), name


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_bytes_of_every_leaf_equal_the_reference(arch):
    """Every leaf of the config's parameter table under every rule set at
    every mesh shape: the spec equal to the reference resolver's (on the
    reference's own table, whose shapes and logical axes equal the port's),
    and the bytes a rank holds equal to what the reference's specs give."""
    port = build_model(get_config(arch)).param_table
    ref = ref_models.build_model(ref_configs.get_config(arch)).param_table
    assert _leaves(port) == [(n, tuple(s), tuple(lg))
                             for n, s, lg in _leaves(ref)]
    for shape in MESHES:
        mesh = _mesh(shape)
        for rules_name in RULE_SETS:
            rules = getattr(sh, rules_name)
            ref_bytes = 0
            for name, shp, logical in _leaves(port):
                want = tuple(ref_sh.logical_to_pspec(logical, rules, mesh,
                                                     shp))
                got = sh.logical_to_pspec(logical, rules, mesh, shp)
                assert got == want, (arch, shape, rules_name, name)
                split = math.prod(shape[a] for e in want if e is not None
                                  for a in ((e,) if isinstance(e, str)
                                            else e))
                ref_bytes += math.prod(shp) // split * 2
            assert sh.param_bytes_per_rank(port, rules, mesh, 2) \
                == ref_bytes, (arch, shape, rules_name)


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_for_equals_the_reference(arch):
    got = sh.rules_for(get_config(arch))
    want = ref_sh.rules_for(ref_configs.get_config(arch))
    assert got == want
    assert got is (sh.FSDP_RULES if want is ref_sh.FSDP_RULES
                   else sh.TP_RULES)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
def test_batch_shardings_and_dp_axes_equal_the_reference(shape):
    mesh = _mesh(shape)
    assert sh.dp_axes(mesh) == ref_sh.dp_axes(mesh)
    specs = {f"b{b}": SimpleNamespace(shape=(b, 7, 3))
             for b in (1, 2, 4, 5, 6, 8, 32, 64, 512)}
    specs["tokens"] = SimpleNamespace(shape=(64, 128))
    ref = ref_sh.batch_shardings(specs, mesh)
    got = sh.batch_shardings(specs, mesh)
    assert {k: v.spec for k, v in got.items()} == {
        k: tuple(v.spec) for k, v in ref.items()}


@pytest.fixture(autouse=True)
def _plain_named_sharding(monkeypatch):
    """The reference builds ``jax.sharding.NamedSharding(mesh, spec)``,
    which wants a real mesh; keep the spec instead."""
    monkeypatch.setattr(ref_sh, "NamedSharding",
                        lambda mesh, spec: SimpleNamespace(spec=spec))


CACHE_PAYLOAD = """
import json, sys
import jax
from repro.configs import get_config
from repro.launch.mesh import make_debug_mesh
from repro.models import build_model
from repro.train.trainer import make_serve_steps

archs, meshes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {}
for arch in archs:
    model = build_model(get_config(arch))
    for data, model_ax in meshes:
        mesh = make_debug_mesh(data=data, model=model_ax)
        serve = make_serve_steps(model, mesh, max_len=2048)
        for batch in (8, 1):
            for prefer in ("time", "width"):
                tree = serve["cache_shardings"](batch, prefer)
                leaves = jax.tree_util.tree_leaves(tree)
                out[f"{arch}/{data}x{model_ax}/{batch}/{prefer}"] = [
                    [list(e) if isinstance(e, tuple) else e
                     for e in s.spec] for s in leaves]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_cache_specs():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(CACHE_PAYLOAD),
         json.dumps(FAMILY_ARCHS), json.dumps([[2, 2], [1, 8]])],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _listed(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cache_layouts_equal_the_reference(arch, reference_cache_specs):
    """``cache_spec`` of every leaf of the family's cache (8 and 1
    sequences of 2048 positions) under both preferences at (2, 2) and
    (1, 8), against the reference's ``cache_shardings`` on host meshes."""
    model = build_model(get_config(arch))
    for data, model_ax in ((2, 2), (1, 8)):
        mesh = _mesh({"data": data, "model": model_ax})
        for batch in (8, 1):
            cache = model.init_cache(batch, 2048, device="meta")
            for prefer in ("time", "width"):
                got = [_listed(sh.cache_spec(leaf.shape, leaf.dtype, mesh,
                                             prefer)) for leaf in cache]
                key = f"{arch}/{data}x{model_ax}/{batch}/{prefer}"
                assert got == reference_cache_specs[key], key


def test_spec_bytes_and_the_plan_of_the_big_configs():
    """The per-rank parameter bytes of the three configs that need several
    cards, bf16 under SERVE_RULES, in GB (the plan chip_smoke.py prints)."""
    want = {"qwen2_72b": (35.7, 17.9, 10.6),
            "qwen3_moe_235b": (117.3, 58.7, 30.3),
            "arctic_480b": (238.4, 119.2, 60.2)}
    for arch, row in want.items():
        table = build_model(get_config(arch)).param_table
        got = tuple(round(sh.param_bytes_per_rank(
            table, sh.SERVE_RULES, _mesh({"data": d, "model": m}), 2) / 1e9,
            1) for d, m in ((1, 4), (1, 8), (2, 8)))
        assert got == row, arch
    assert sh.spec_bytes((8, 6), ("data", None), _mesh({"data": 2}), 4) \
        == 96
    assert sh.spec_bytes((8, 6), (("data", "model"), None),
                         _mesh({"data": 2, "model": 4}), 2) == 12


def test_constrain_is_the_identity_on_a_plain_tensor():
    constrain = sh.make_constrain(_mesh({"data": 2, "model": 2}))
    x = torch.randn(4, 3, 8)
    assert constrain(x, (("batch",), None, "embed")) is x


def test_table_shapes_nests_as_the_parameters():
    model = build_model(get_config("stablelm_12b"))
    shapes = sh.table_shapes(model.param_table)
    assert shapes["layers"]["mlp"]["wi_0"] == torch.Size(
        model.param_table["layers/mlp/wi_0"][0])
    got = sh.param_shardings(model.logical, _mesh({"data": 2, "model": 4}),
                             sh.SERVE_RULES, shapes)
    assert got["layers"]["mlp"]["wi_0"].spec == (None, None,
                                                 ("model", "data"))
    assert got["embed"].spec == ("model", None)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_shardings_equal_the_reference(arch, opt):
    """The moments' logical axes (``opt_logical``) equal the reference's
    ``_state_logical``, and ``state_shardings`` gives every parameter and
    moment the reference's spec (its rule on the moment's own shape, from
    ``jax.eval_shape`` of its ``init_opt_state``) at every mesh shape,
    under ``rules_for``; the step is left to every rank (``None``)."""
    import jax
    import jax.numpy as jnp
    from repro.train import optimizers as ref_opt
    from repro.train.trainer import _state_logical
    from repro_torch.train.optimizers import OptConfig, tree_leaves

    model = build_model(get_config(arch))
    rmodel = ref_models.build_model(ref_configs.get_config(arch))
    cfg, rcfg = OptConfig(name=opt), ref_opt.OptConfig(name=opt)
    _, ref_logical = _state_logical(rmodel, rcfg)
    assert sh.opt_logical(model.logical, cfg) == jax.tree_util.tree_map(
        tuple, ref_logical, is_leaf=sh._is_logical)
    p_shapes = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(tuple(s), jnp.float32),
        sh.table_shapes(model.param_table),
        is_leaf=lambda x: isinstance(x, torch.Size))
    o_shapes = jax.eval_shape(lambda: ref_opt.init_opt_state(p_shapes, rcfg))
    is_lg = sh._is_logical
    rules = sh.rules_for(model.cfg)
    for shape in MESHES:
        mesh = _mesh(shape)
        got = sh.state_shardings(model, mesh, rules, cfg)
        assert got.step is None
        want = [tuple(ref_sh.logical_to_pspec(lg, rules, mesh, s.shape))
                for lg, s in zip(
                    jax.tree_util.tree_leaves(ref_logical, is_leaf=is_lg),
                    jax.tree_util.tree_leaves(o_shapes))]
        assert [n.spec for n in tree_leaves(got.opt_state)] == want, shape
        assert [n.spec for n in tree_leaves(got.params)] == [
            sh.logical_to_pspec(lg, rules, mesh, tuple(s))
            for lg, s in zip(tree_leaves(model.logical),
                             tree_leaves(sh.table_shapes(
                                 model.param_table)))]
