"""PyTorch port, the serve steps on a device mesh (``make_serve_steps(...,
mesh=...)``, ``DTensor`` placements by ``SERVE_RULES``) and the
expert-parallel MoE (``moe_ffn_sharded``, ``moe_ffn_sharded_decode`` and
their per-rank bodies), over gloo ranks on the CPU, held against:

* the reference's jitted sharded steps and ``shard_map`` MoE on the same
  (data 2, model 2) mesh of host devices (a subprocess with the XLA
  device-count flag), within 1e-5 of max|reference|;
* the port's one-device steps and ``moe_ffn``, on the same numpy
  parameters and inputs (made here from a seed; both packages read the
  same file).

Four ranks (a ``file://`` rendezvous in ``tmp_path``, no ports) run the
(2, 2) mesh, eight the (pod 2, data 2, model 2) one. The ranks and the
reference run once for the module; the tests read what they wrote.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.moe import moe_param_table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (arch, batch): one config of each family at a batch the data axis
# divides, and RWKV at a batch it does not (5 over 2).
CASES = (("stablelm_12b", 4), ("llava_next_mistral_7b", 4),
         ("qwen3_moe_235b", 4), ("recurrentgemma_2b", 4),
         ("rwkv6_1b6", 4), ("whisper_tiny", 4), ("rwkv6_1b6", 5))
SEQ, STEPS = 8, 3
MOE_ARCH = "qwen3_moe_235b"
TOL = 1e-5               # of max|reference|
GROUPS_TOL = 2e-4        # the reference test's band against moe_ffn(groups=2)
TIMEOUT = 300


def _case(arch, batch):
    return f"{arch}@{batch}"


def make_inputs(path):
    """Parameters and inputs of every case and of the MoE layer, float32
    numpy from one seed (weights fan-in scaled, the rest 0.1-scaled)."""
    rng = np.random.default_rng(0)
    arrays = {}
    for arch, batch in CASES:
        cfg = get_smoke_config(arch)
        key = _case(arch, batch)
        for name, (shape, _, fan) in build_model(cfg).param_table.items():
            std = fan ** -0.5 if fan else 0.1
            arrays[f"{key}/params/{name}"] = (
                rng.standard_normal(shape) * std).astype(np.float32)
        arrays[f"{key}/tokens"] = rng.integers(
            0, cfg.vocab_size, (batch, SEQ)).astype(np.int32)
        arrays[f"{key}/decode_tokens"] = rng.integers(
            0, cfg.vocab_size, (STEPS, batch, 1)).astype(np.int32)
        if cfg.family in ("audio", "encdec"):
            arrays[f"{key}/frames"] = rng.standard_normal(
                (batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            arrays[f"{key}/prefix_embeds"] = rng.standard_normal(
                (batch, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    cfg = get_smoke_config(MOE_ARCH)
    for name, (shape, _, fan) in moe_param_table(cfg).items():
        arrays[f"moe/{name}"] = (rng.standard_normal(shape)
                                 * fan ** -0.5).astype(np.float32)
    for name, shape in (("x", (4, 8)), ("x_decode", (4, 1)),
                        ("x_decode5", (5, 1)), ("x_big", (4, 1100))):
        arrays[f"moe/{name}"] = rng.standard_normal(
            (*shape, cfg.d_model)).astype(np.float32)
    arrays["moe/w"] = rng.standard_normal(
        (4, 8, cfg.d_model)).astype(np.float32)
    np.savez(path, **arrays)


REFERENCE = """
import dataclasses, json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.configs import get_smoke_config
from repro.distributed.sharding import dp_axes
from repro.launch.mesh import make_debug_mesh
from repro.models import build_model
from repro.models.moe import moe_ffn, moe_ffn_sharded, moe_ffn_sharded_decode
from repro.train.trainer import make_serve_steps

inp = dict(np.load(sys.argv[1]))
cases = json.loads(sys.argv[3])
seq, steps = int(sys.argv[4]), int(sys.argv[5])


def tree(prefix):
    out = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            node = out
            *parents, leaf = k[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
    return out


out = {}
mesh = make_debug_mesh(data=2, model=2)
for arch, batch in cases:
    key = f"{arch}@{batch}"
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    max_len = seq + steps + (getattr(cfg, "num_patch_tokens", 0) or 0)
    serve = make_serve_steps(model, mesh, max_len=max_len)
    params = jax.device_put(tree(f"{key}/params/"), serve["param_shardings"])
    feed = {k: jnp.asarray(inp[f"{key}/{k}"])
            for k in ("tokens", "frames", "prefix_embeds")
            if f"{key}/{k}" in inp}
    with mesh:
        logits, cache = jax.jit(serve["prefill"])(params, feed)
        got = [np.asarray(logits)]
        step = jax.jit(serve["decode_step"])
        for fed in inp[f"{key}/decode_tokens"]:
            logits, cache = step(params, cache, jnp.asarray(fed))
            got.append(np.asarray(logits))
    out[f"{key}/logits"] = np.stack(got)

cfg = get_smoke_config("qwen3_moe_235b")
lp = {k: jnp.asarray(inp[f"moe/{k}"]) for k in ("router", "wi_0", "wi_1",
                                                 "wo")}
x, w = jnp.asarray(inp["moe/x"]), jnp.asarray(inp["moe/w"])
for tag, cf in (("default", cfg.capacity_factor),
                ("dropless", cfg.num_experts / cfg.moe_top_k)):
    c = dataclasses.replace(cfg, capacity_factor=cf)
    with mesh:
        for name, fn, arg in (("sharded", moe_ffn_sharded, "x"),
                              ("decode", moe_ffn_sharded_decode, "x_decode"),
                              ("big", moe_ffn_sharded, "x_big")):
            out[f"moe/{tag}/{name}"] = np.asarray(jax.jit(
                lambda a, p, fn=fn, c=c: fn(a, p, c, mesh))(
                    jnp.asarray(inp[f"moe/{arg}"]), lp))
with mesh:
    out["moe/decode5"] = np.asarray(jax.jit(
        lambda a, p: moe_ffn_sharded_decode(a, p, cfg, mesh))(
            jnp.asarray(inp["moe/x_decode5"]), lp))
xd, wd = jnp.asarray(inp["moe/x_decode"]), jnp.asarray(inp["moe/w"][:, :1])
# each path's gradient of sum(out * w), and the einsum path's (the data
# shards' grouping, or every token in one group as the decode gathers them)
for name, fn, a, wt, groups in (
        ("sharded", moe_ffn_sharded, x, w, 2),
        ("decode", moe_ffn_sharded_decode, xd, wd, 1)):
    with mesh:
        gx, gp = jax.grad(lambda a, p: jnp.sum(fn(a, p, cfg, mesh) * wt),
                          argnums=(0, 1))(a, lp)
    ge = jax.grad(lambda a, p: jnp.sum(moe_ffn(a, p, cfg, groups) * wt),
                  argnums=(0, 1))(a, lp)
    for tag, (g_x, g_p) in (("grad", (gx, gp)), ("grad_einsum", ge)):
        out[f"moe/{tag}/{name}/x"] = np.asarray(g_x)
        for k, v in g_p.items():
            out[f"moe/{tag}/{name}/{k}"] = np.asarray(v)

pod = make_debug_mesh(data=2, model=2, pod=2)
out["pod/dp_axes"] = np.array(list(dp_axes(pod)))
xd = jnp.asarray(inp["moe/x_decode"])
with pod:
    out["pod/decode"] = np.asarray(jax.jit(
        lambda a, p: moe_ffn_sharded_decode(a, p, cfg, pod))(xd, lp))


def gather(xl):
    for ax in ("pod", "data"):
        xl = jax.lax.all_gather(xl, ax, axis=0, tiled=True)
    return xl


out["pod/x_all"] = np.asarray(shard_map(
    gather, mesh=pod, in_specs=(P(("pod", "data"), None, None),),
    out_specs=P(), check_vma=False)(xd))
np.savez(sys.argv[2], **out)
"""

RANK = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, init, out_path, in_path = (int(sys.argv[1]), int(sys.argv[2]),
                                        *sys.argv[3:6])
cases = json.loads(sys.argv[6])
seq, steps = int(sys.argv[7]), int(sys.argv[8])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
from repro_torch import tree_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model, moe, table_logical
from repro_torch.train.trainer import make_serve_steps

inp = dict(np.load(in_path))
res = {}
full = sh.full_value
CPU = "cpu"


def tree(prefix):
    return tree_from_numpy({k[len(prefix):]: v for k, v in inp.items()
                            if k.startswith(prefix)}, device=CPU)


def moe_inputs():
    cfg = get_smoke_config("qwen3_moe_235b")
    table = moe.moe_param_table(cfg)
    lp = tree("moe/")
    lp = {k: lp[k] for k in table}
    return cfg, table, lp


if world == 4:
    mesh = make_debug_mesh(data=2, model=2)
    for arch, batch in cases:
        key = f"{arch}@{batch}"
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        params = tree(f"{key}/params/")
        max_len = seq + steps + (cfg.num_patch_tokens or 0)
        feed = {k: torch.from_numpy(inp[f"{key}/{k}"])
                for k in ("tokens", "frames", "prefix_embeds")
                if f"{key}/{k}" in inp}
        one = make_serve_steps(model, max_len, CPU)
        on_mesh = make_serve_steps(model, max_len, CPU, mesh=mesh)
        placed = sh.shard_params(params, mesh, sh.SERVE_RULES, model.logical)
        for name, steps_, p in (("one", one, params),
                                ("mesh", on_mesh, placed)):
            logits, cache = steps_["prefill"](p, feed)
            if name == "mesh":
                width = on_mesh["cache_shardings"](batch, "width")
                res[f"{key}/width_layout"] = np.array(all(
                    leaf.placements == tuple(s.placements)
                    for leaf, s in zip(cache, width) if leaf.ndim >= 2))
            got = [full(logits)]
            for fed in inp[f"{key}/decode_tokens"]:
                logits, cache = steps_["decode_step"](p, cache,
                                                      torch.from_numpy(fed))
                got.append(full(logits))
            res[f"{key}/{name}"] = torch.stack(got).numpy()
        specs = {prefer: [list(s.spec) for s in on_mesh["cache_shardings"](
                     batch, prefer)] for prefer in ("time", "width")}
        want = {prefer: [list(sh.cache_spec(l.shape, l.dtype, mesh, prefer))
                         for l in model.init_cache(batch, max_len,
                                                   device="meta")]
                for prefer in ("time", "width")}
        res[f"{key}/cache_shardings_ok"] = np.array(specs == want)

    cfg, table, lp = moe_inputs()
    placed = sh.shard_params(lp, mesh, sh.SERVE_RULES, table_logical(table))
    E = cfg.num_experts
    x = torch.from_numpy(inp["moe/x"])
    xd = torch.from_numpy(inp["moe/x_decode"])
    d_rank, m_rank = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    res["coords"] = np.array([d_rank, m_rank])
    for tag, cf in (("default", cfg.capacity_factor),
                    ("dropless", E / cfg.moe_top_k)):
        c = cfg.replace(capacity_factor=cf)
        with torch.no_grad():
            res[f"moe/{tag}/sharded"] = full(moe.moe_ffn_sharded(
                x, placed, c, mesh)).numpy()
            res[f"moe/{tag}/decode"] = full(moe.moe_ffn_sharded_decode(
                xd, placed, c, mesh)).numpy()
            res[f"moe/{tag}/big"] = full(moe.moe_ffn_sharded(
                torch.from_numpy(inp["moe/x_big"]), placed, c, mesh)).numpy()
            res[f"moe/{tag}/groups2"] = moe.moe_ffn(x, lp, c, 2).numpy()
            res[f"moe/{tag}/groups1_decode"] = moe.moe_ffn(xd, lp, c,
                                                           1).numpy()
            # the bodies by direct call, on this rank's blocks
            wspec = ("model", None, None)
            blocks = [sh.to_local(lp[k], mesh, wspec)
                      for k in ("wi_0", "wi_1", "wo")]
            res[f"moe/{tag}/local_moe"] = moe._local_moe(
                sh.to_local(x, mesh, ("data", None, None)), lp["router"],
                *blocks, c, E // 2, m_rank, mesh.get_group("model")).numpy()
            blocks = [sh.to_local(lp[k], mesh, spec) for k, spec in (
                ("wi_0", ("model", None, "data")),
                ("wi_1", ("model", None, "data")),
                ("wo", ("model", "data", None)))]
            res[f"moe/{tag}/local_moe_gathered"] = \\
                moe._local_moe_tokens_gathered(
                    sh.to_local(xd, mesh, ("data", None, None)),
                    lp["router"], *blocks, c, E // 2,
                    ((d_rank, mesh.get_group("data"), 2),),
                    (m_rank, mesh.get_group("model")),
                    mesh.get_group("data")).numpy()
    with torch.no_grad():
        x5 = torch.from_numpy(inp["moe/x_decode5"])
        res["moe/decode5"] = full(moe.moe_ffn_sharded_decode(
            x5, placed, cfg, mesh)).numpy()
        res["moe/groups1_decode5"] = moe.moe_ffn(x5, lp, cfg, 1).numpy()
    # the gradients through the expert-parallel paths, on placed leaves
    w = torch.from_numpy(inp["moe/w"])
    for name, fn, a, wt in (("sharded", moe.moe_ffn_sharded, x, w),
                            ("decode", moe.moe_ffn_sharded_decode, xd,
                             w[:, :1])):
        xg = sh.shard_tensor(a, mesh, (None, None, None)).detach()
        xg.requires_grad_()
        pg = {k: v.detach().requires_grad_() for k, v in placed.items()}
        out = fn(xg, pg, cfg, mesh)
        (out * sh.shard_tensor(wt, mesh, (None, None, None))).sum() \
            .full_tensor().backward()
        res[f"moe/grad/{name}/x"] = xg.grad.full_tensor().numpy()
        for k, v in pg.items():
            res[f"moe/grad/{name}/{k}"] = v.grad.full_tensor().numpy()
else:
    from repro_torch.launch.mesh import make_production_mesh
    single = make_production_mesh()
    res["production"] = np.array([single.mesh_dim_names,
                                  [str(n) for n in single.mesh.shape]])
    try:
        make_production_mesh(multi_pod=True)
        res["multi_refused"] = np.array("")
    except ValueError as err:
        res["multi_refused"] = np.array(str(err))
    mesh = make_debug_mesh(data=2, model=2, pod=2)
    res["dp_axes"] = np.array(list(sh.dp_axes(mesh)))
    cfg, table, lp = moe_inputs()
    placed = sh.shard_params(lp, mesh, sh.SERVE_RULES, table_logical(table))
    xd = torch.from_numpy(inp["moe/x_decode"])
    with torch.no_grad():
        res["decode"] = full(moe.moe_ffn_sharded_decode(
            xd, placed, cfg, mesh)).numpy()
        res["groups1_decode"] = moe.moe_ffn(xd, lp, cfg, 1).numpy()
        x_all = sh.to_local(xd, mesh, (("pod", "data"), None, None))
        for ax in ("pod", "data"):
            x_all = moe._all_gather0(x_all, mesh.get_group(ax))
        res["x_all"] = x_all.numpy()
np.savez(out_path, **res)
dist.destroy_process_group()
"""


def _start_ranks(tmp, world, env):
    init = tmp / f"rendezvous{world}"
    return [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(RANK), str(r), str(world),
         str(init), str(tmp / f"w{world}_rank{r}.npz"),
         str(tmp / "inputs.npz"), json.dumps(CASES), str(SEQ), str(STEPS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]


def _wait(procs):
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference (8 host devices) and the 4 ranks at once, then the 8
    ranks: {"ref": ..., "w4": [per rank], "w8": [per rank]}."""
    tmp = tmp_path_factory.mktemp("sharded")
    make_inputs(tmp / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    ref_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         str(tmp / "inputs.npz"), str(tmp / "reference.npz"),
         json.dumps(CASES), str(SEQ), str(STEPS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=ref_env)
    try:
        _wait(_start_ranks(tmp, 4, env))
    finally:
        _wait([ref])
    _wait(_start_ranks(tmp, 8, env))
    load = lambda name: dict(np.load(tmp / name))
    return {"ref": load("reference.npz"),
            "w4": [load(f"w4_rank{r}.npz") for r in range(4)],
            "w8": [load(f"w8_rank{r}.npz") for r in range(8)]}


def _close(got, want, tol, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("arch,batch", CASES,
                         ids=[_case(a, b) for a, b in CASES])
def test_prefill_and_decode_on_the_mesh(runs, arch, batch):
    """Prefill + 3 decode steps on the (2, 2) mesh: the reference's jitted
    sharded steps and the port's one-device steps within 1e-5 of
    max|reference|, every rank the same logits, the cache in the prefill's
    'width' layout, ``cache_shardings`` by ``cache_spec``."""
    key = _case(arch, batch)
    ranks = runs["w4"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{key}/mesh"],
                                      ranks[0][f"{key}/mesh"])
    got = ranks[0][f"{key}/mesh"]
    _close(got, runs["ref"][f"{key}/logits"], TOL, "reference")
    _close(got, ranks[0][f"{key}/one"], TOL, "one device")
    _close(ranks[0][f"{key}/one"], runs["ref"][f"{key}/logits"], TOL,
           "one device against the reference")
    assert all(bool(r[f"{key}/width_layout"]) for r in ranks)
    assert all(bool(r[f"{key}/cache_shardings_ok"]) for r in ranks)


@pytest.mark.parametrize("tag", ["default", "dropless"])
def test_expert_parallel_moe_matches_the_reference(runs, tag):
    """``moe_ffn_sharded`` (8 x 4 tokens; 4 x 1100, beyond the decode
    variant's 4096) and ``moe_ffn_sharded_decode`` (4 x 1) on (2, 2) at the
    default capacity factor (drops) and a dropless one: the reference's
    within 1e-5 of max|reference|; ``moe_ffn_sharded`` against the port's
    ``moe_ffn(num_groups=2)`` in the reference test's band, the decode
    variant (every token gathered) against ``moe_ffn(num_groups=1)``."""
    ranks, ref = runs["w4"], runs["ref"]
    for name in ("sharded", "decode", "big"):
        for r in ranks:
            _close(r[f"moe/{tag}/{name}"], ref[f"moe/{tag}/{name}"], TOL,
                   name)
    r0 = ranks[0]
    _close(r0[f"moe/{tag}/sharded"], r0[f"moe/{tag}/groups2"], GROUPS_TOL,
           "groups2")
    _close(r0[f"moe/{tag}/decode"], r0[f"moe/{tag}/groups1_decode"], TOL,
           "groups1")


def test_moe_decode_at_a_batch_the_data_axis_does_not_divide(runs):
    """5 tokens on (2, 2): not gathered over 'data', whose ranks still hold
    different slices of F. The port sums them: ``moe_ffn(num_groups=1)``
    within 1e-5. The reference sums only over the axes it gathered over and
    returns a partial sum over F (a reference caveat): it misses by more
    than the output's tenth."""
    r0, ref = runs["w4"][0], runs["ref"]
    _close(r0["moe/decode5"], r0["moe/groups1_decode5"], TOL, "decode5")
    want = r0["moe/groups1_decode5"]
    assert np.abs(ref["moe/decode5"] - want).max() > 0.1 * np.abs(want).max()


@pytest.mark.parametrize("tag", ["default", "dropless"])
def test_moe_bodies_by_direct_call(runs, tag):
    """``_local_moe`` on a rank's token block and expert block, summed over
    the model axis, is that block's rows of the reference's output;
    ``_local_moe_tokens_gathered`` on its token block is its rows of the
    decode output."""
    ref = runs["ref"]
    for r in runs["w4"]:
        d = int(r["coords"][0])
        _close(r[f"moe/{tag}/local_moe"],
               ref[f"moe/{tag}/sharded"][2 * d:2 * d + 2], TOL, "local")
        _close(r[f"moe/{tag}/local_moe_gathered"],
               ref[f"moe/{tag}/decode"][2 * d:2 * d + 2], TOL, "gathered")


@pytest.mark.parametrize("name", ["sharded", "decode"])
def test_moe_gradient_against_the_reference(runs, name):
    """The gradient of sum(out * w) with respect to the input and every
    weight through ``moe_ffn_sharded`` (8 x 4 tokens) and
    ``moe_ffn_sharded_decode`` (4 x 1) on placed leaves: the reference's
    ``jax.grad`` through its ``shard_map`` (``check_vma=False``) and the
    einsum path's gradient within 1e-5 of max|reference|, every rank the
    same. DTensor sums each rank's share (``sharding.to_local`` declares
    the blocks' gradients partial); the sum over the model axis, whose
    result every rank uses alike, passes its gradient through once."""
    ref, r0 = runs["ref"], runs["w4"][0]
    for k in ("x", "router", "wi_0", "wi_1", "wo"):
        key = f"moe/grad/{name}/{k}"
        _close(r0[key], ref[key], TOL, f"reference {k}")
        _close(r0[key], ref[f"moe/grad_einsum/{name}/{k}"], TOL,
               f"einsum {k}")
        for r in runs["w4"][1:]:
            np.testing.assert_array_equal(r[key], r0[key])


def test_production_meshes_over_eight_ranks(runs):
    """Eight ranks make one 8-card node: ``make_production_mesh()`` is
    (data 1, model 8); the two-pod mesh is refused, naming the 16 ranks it
    needs."""
    for r in runs["w8"]:
        assert r["production"].tolist() == [["data", "model"], ["1", "8"]]
        assert "multiple of 16 ranks" in str(r["multi_refused"])


def test_pod_axis_gather_and_decode(runs):
    """(pod 2, data 2, model 2) over eight ranks: ``dp_axes`` and the
    decode MoE's token gather (pod, then data) equal to the reference's;
    the decode output equal to ``moe_ffn(num_groups=1)``. The reference's
    decode output sums over the pod axis too, whose ranks hold the same
    tokens and weights: twice the right answer (a reference caveat)."""
    ref = runs["ref"]
    for r in runs["w8"]:
        assert list(r["dp_axes"]) == list(ref["pod/dp_axes"])
        np.testing.assert_array_equal(r["x_all"], ref["pod/x_all"])
        _close(r["decode"], r["groups1_decode"], TOL, "decode")
    _close(ref["pod/decode"], 2.0 * runs["w8"][0]["groups1_decode"], TOL,
           "reference's doubled decode")
