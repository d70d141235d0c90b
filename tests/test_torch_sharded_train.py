"""PyTorch port, training on a device mesh over gloo ranks on the CPU:
``make_train_step(..., mesh=...)`` (state placed by ``rules_for``, the
batch over the data axes, gradients in their parameters' placements), the
vocab-parallel cross-entropy, the int8 all-reduce over 'pod'
(``train/compression.py``) and the GPipe schedule over 'pod'
(``train/pipeline.py``), held against:

* the reference's ``make_train_step(model, mesh)`` and ``jax.grad`` of its
  loss on the same (data 2, model 2) mesh of host devices, its
  ``pipelined_forward`` and ``quantize_leaf`` (a subprocess with the XLA
  device-count flag), on the same numpy parameters and inputs;
* the port's one-device step and loss on the same inputs.

Four ranks run the (2, 2) mesh in two worlds at once (each world a share
of the families), two ranks the (1, 2) mesh of the loss test, eight the
(pod 2, data 2, model 2) mesh of compression and the pipeline; a
``file://`` rendezvous in ``tmp_path``, no ports. The ranks and the
reference run once for the module; the tests read what they wrote.
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.train.compression import make_compressed_allreduce

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("stablelm_12b", "llava_next_mistral_7b", "qwen3_moe_235b",
         "recurrentgemma_2b", "rwkv6_1b6", "whisper_tiny")
# the families of each four-rank world, and what else it runs
WORLDS = {"a": ("stablelm_12b", "qwen3_moe_235b", "rwkv6_1b6"),
          "b": ("llava_next_mistral_7b", "recurrentgemma_2b",
                "whisper_tiny")}
BATCH, SEQ = 4, 8
OPT = dict(peak_lr=3e-3, warmup_steps=2, decay_steps=10, weight_decay=0.1)
# Adafactor with grad_accum=2 on stablelm_12b: a factoring threshold the
# smoke widths reach (64), so factored moments of split leaves are stepped
ADA = dict(arch="stablelm_12b", batch=8, steps=3, accum=2,
           factored_min_dim=64)
MOE_ARCH = "qwen3_moe_235b"
CE_VOCABS = (32, 33)        # 'model' divides 32, not 33
TOL = 1e-5                  # loss, grad_norm: relative; gradients: of max|g|
CURVE_TOL = 1e-4
CE_TOL = 1e-6
PIPE = dict(S=2, L=3, D=16, M=4, batch=8)
TIMEOUT = 400


def make_inputs(path):
    """Parameters and inputs of every family and of the pipeline and
    compression checks, float32 numpy from one seed."""
    rng = np.random.default_rng(0)
    arrays = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        for name, (shape, _, fan) in build_model(cfg).param_table.items():
            std = fan ** -0.5 if fan else 0.1
            arrays[f"{arch}/params/{name}"] = (
                rng.standard_normal(shape) * std).astype(np.float32)
        batch = ADA["batch"] if arch == ADA["arch"] else BATCH
        steps = ADA["steps"] if arch == ADA["arch"] else 1
        for k in ("tokens", "labels"):
            arrays[f"{arch}/{k}"] = rng.integers(
                0, cfg.vocab_size, (steps, batch, SEQ)).astype(np.int32)
        arrays[f"{arch}/labels"][0, 0, :2] = -1          # ignored labels
        if cfg.family in ("audio", "encdec"):
            arrays[f"{arch}/frames"] = rng.standard_normal(
                (steps, batch, cfg.enc_frames, cfg.d_model)).astype(
                    np.float32)
        if cfg.family == "vlm":
            arrays[f"{arch}/prefix_embeds"] = rng.standard_normal(
                (steps, batch, cfg.num_patch_tokens, cfg.d_model)).astype(
                    np.float32)
    S, L, D = PIPE["S"], PIPE["L"], PIPE["D"]
    arrays["pipe/w"] = (rng.standard_normal((S, L, D, D)) * 0.1).astype(
        np.float32)
    arrays["pipe/x"] = rng.standard_normal((PIPE["batch"], D)).astype(
        np.float32)
    arrays["pipe/wt"] = rng.standard_normal((PIPE["batch"], D)).astype(
        np.float32)
    # compression: the reference test's tree, and one whose max is 127 so
    # that its step is 1 and x.5 falls exactly half-way (half to even)
    arrays["comp/a"] = np.linspace(-1, 1, 64, dtype=np.float32).reshape(8, 8)
    arrays["comp/b"] = np.array([1e-3, 5.0, -2.0], np.float32)
    arrays["comp/c"] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 3.0],
                                np.float32)
    arrays["comp/e_c"] = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5],
                                  np.float32)
    np.savez(path, **arrays)


REFERENCE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.distributed.sharding import make_constrain
from repro.launch.mesh import make_debug_mesh
from repro.models import build_model
from repro.train.compression import make_compressed_allreduce, quantize_leaf
from repro.train.optimizers import OptConfig, init_opt_state
from repro.train.pipeline import pipelined_forward
from repro.train.trainer import TrainState, make_train_step

inp = dict(np.load(sys.argv[1]))
cfg_in = eval(sys.argv[3])
out = {}


def tree(prefix):
    t = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            node = t
            *parents, leaf = k[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
    return t


def flat(t, prefix):
    for k, v in t.items():
        if isinstance(v, dict):
            flat(v, f"{prefix}/{k}")
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def batch_at(arch, i):
    return {k: jnp.asarray(inp[f"{arch}/{k}"][i])
            for k in ("tokens", "labels", "frames", "prefix_embeds")
            if f"{arch}/{k}" in inp}


mesh = make_debug_mesh(data=2, model=2)
constrain = make_constrain(mesh)
for arch in cfg_in["archs"]:
    model = build_model(get_smoke_config(arch))
    ocfg = OptConfig(**cfg_in["opt"])
    setup = make_train_step(model, mesh, opt_cfg=ocfg, donate=False)
    params = tree(f"{arch}/params/")
    state = jax.device_put(
        TrainState(params, init_opt_state(params, ocfg),
                   jnp.zeros((), jnp.int32)), setup.state_shardings)
    batch = batch_at(arch, 0)
    with mesh:
        _, metrics = setup.step_fn(state, batch)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss(p, b, constrain=constrain)))(
                state.params, batch)
    out[f"{arch}/loss"] = np.asarray(metrics["loss"])
    out[f"{arch}/grad_norm"] = np.asarray(metrics["grad_norm"])
    out[f"{arch}/value"] = np.asarray(loss)
    flat(grads, f"{arch}/grad")

ada = cfg_in["ada"]
model = build_model(get_smoke_config(ada["arch"]))
ocfg = OptConfig(name="adafactor", factored_min_dim=ada["factored_min_dim"],
                 **cfg_in["opt"])
setup = make_train_step(model, mesh, opt_cfg=ocfg, grad_accum=ada["accum"],
                        donate=False)
params = tree(f"{ada['arch']}/params/")
state = jax.device_put(TrainState(params, init_opt_state(params, ocfg),
                                  jnp.zeros((), jnp.int32)),
                       setup.state_shardings)
losses = []
with mesh:
    for i in range(ada["steps"]):
        state, metrics = setup.step_fn(state, batch_at(ada["arch"], i))
        losses.append(float(metrics["loss"]))
out["ada/losses"] = np.array(losses)

pod = make_debug_mesh(data=2, model=2, pod=2)


def stage_fn(sp, x):
    def body(h, w):
        return jnp.tanh(h @ w), None
    h, _ = jax.lax.scan(body, x, sp["w"])
    return h


pipe = pipelined_forward(pod, stage_fn, num_microbatches=cfg_in["pipe"]["M"])
w, x, wt = (jnp.asarray(inp[f"pipe/{k}"]) for k in ("w", "x", "wt"))
with pod:
    out["pipe/y"] = np.asarray(pipe({"w": w}, x))
    out["pipe/grad"] = np.asarray(jax.grad(
        lambda w: jnp.sum(pipe({"w": w}, x) * wt))(w))

comp = {k: jnp.asarray(inp[f"comp/{k}"]) for k in ("a", "b", "c")}
zeros = {k: jnp.zeros_like(v) for k, v in comp.items()}
errs = dict(zeros, c=jnp.asarray(inp["comp/e_c"]))
for tag, e in (("zero", zeros), ("carried", errs)):
    for k in comp:
        q, s, ne = quantize_leaf(comp[k], e[k])
        out[f"quant/{tag}/{k}/q"] = np.asarray(q)
        out[f"quant/{tag}/{k}/scale"] = np.asarray(s)
        out[f"quant/{tag}/{k}/error"] = np.asarray(ne)
with pod:
    g, e = jax.jit(make_compressed_allreduce(pod))(comp, zeros)
for k in comp:
    out[f"allreduce/{k}/g"] = np.asarray(g[k])
    out[f"allreduce/{k}/e"] = np.asarray(e[k])
np.savez(sys.argv[2], **out)
"""

RANK = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, init, out_path, in_path = (int(sys.argv[1]), int(sys.argv[2]),
                                        *sys.argv[3:6])
job = json.loads(sys.argv[6])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
from repro_torch import tree_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model, layers, transformer
from repro_torch.train import OptConfig, TrainState, init_opt_state
from repro_torch.train.optimizers import tree_leaves
from repro_torch.train.trainer import make_train_step

inp = dict(np.load(in_path))
res = {}
full = sh.full_value
CPU = "cpu"


def tree(prefix):
    return tree_from_numpy({k[len(prefix):]: v for k, v in inp.items()
                            if k.startswith(prefix)}, device=CPU)


def paths(t, prefix=""):
    if isinstance(t, dict):
        return [p for k in sorted(t) for p in paths(t[k], f"{prefix}/{k}")]
    return [prefix]


def batch_at(arch, i):
    return {k: torch.from_numpy(inp[f"{arch}/{k}"][i])
            for k in ("tokens", "labels", "frames", "prefix_embeds")
            if f"{arch}/{k}" in inp}


def state_of(params, setup, ocfg):
    opt = init_opt_state(params, ocfg, None if setup.state_shardings is None
                         else setup.state_shardings.opt_state)
    return TrainState(params, opt, torch.zeros((), dtype=torch.int32))


def placed(params, setup, shardings=None):
    shardings = setup.state_shardings.params if shardings is None \
        else shardings
    if isinstance(params, dict):
        return {k: placed(v, setup, shardings[k]) for k, v in params.items()}
    return sh.shard_tensor(params, shardings.mesh, shardings.spec)


def ce_case(mesh, V, x_spec):
    # the loss of one chunked_ce_loss on an embed split over 'model' (its
    # vocab) and x by x_spec, against the one-device loss
    rng = np.random.default_rng(V)
    B, S, D = 2, 8, 16
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(-1, V, (B, S)).astype(np.int64))
    one = [t.clone().requires_grad_() for t in (x, emb)]
    loss = layers.chunked_ce_loss(one[0], one[1], lab, chunk=4)
    loss.backward()
    from torch.distributed.tensor.experimental import implicit_replication
    xd = sh.shard_tensor(x, mesh, x_spec).detach().requires_grad_()
    ed = sh.shard_tensor(emb, mesh, ("model", None)).detach() \
        .requires_grad_()
    with implicit_replication():
        got = layers.chunked_ce_loss(xd, ed, lab, chunk=4).full_tensor()
        got.backward()
    tag = f"ce/{V}/{'split' if x_spec[0] else 'whole'}"
    res[f"{tag}/loss"] = np.array([float(loss), float(got)])
    for name, a, b in (("x", one[0], xd), ("embed", one[1], ed)):
        res[f"{tag}/{name}/one"] = a.grad.numpy()
        res[f"{tag}/{name}/mesh"] = full(b.grad).numpy()


# the table's layouts of the embedding lookup cases
EMB_LAYOUTS = {"vocab": ("model", None), "vocab_embed": ("model", "data"),
               "zero": (("data", "model"), None)}


def embed_case(mesh, V, layout):
    # layers.embed_lookup on a table laid out by EMB_LAYOUTS[layout], the
    # tokens' batch over 'data', against the one-device lookup: the rows
    # and the table's gradient of a weighted sum of them
    rng = np.random.default_rng(V + 1)
    B, S, D = 4, 6, 8
    emb = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32))
    tok = torch.from_numpy(rng.integers(0, V, (B, S)).astype(np.int64))
    w = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    one = emb.clone().requires_grad_()
    out = layers.embed_lookup(one, tok)
    (out * w).sum().backward()
    ed = sh.shard_tensor(emb, mesh, EMB_LAYOUTS[layout]).detach() \
        .requires_grad_()
    got = layers.embed_lookup(ed, sh.shard_tensor(tok, mesh, ("data", None)))
    wd = sh.shard_tensor(w, mesh, ("data", None, None))
    (got.redistribute(mesh, wd.placements) * wd).sum().backward()
    tag = f"emb/{V}/{layout}"
    res[f"{tag}/out/one"] = out.detach().numpy()
    res[f"{tag}/out/mesh"] = full(got).detach().numpy()
    res[f"{tag}/grad/one"] = one.grad.numpy()
    res[f"{tag}/grad/mesh"] = full(ed.grad).numpy()


if job["kind"] == "families":
    mesh = make_debug_mesh(data=2, model=2)
    calls = []

    def counted(real):
        def run(*a, **k):
            calls.append(1)
            return real(*a, **k)
        return run
    for name in ("moe_ffn_sharded", "moe_ffn_sharded_decode"):
        setattr(transformer, name, counted(getattr(transformer, name)))
    for arch in job["archs"]:
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        ocfg = OptConfig(**job["opt"])
        params = tree(f"{arch}/params/")
        one = make_train_step(model, ocfg, device=CPU)
        on = make_train_step(model, ocfg, device=CPU, mesh=mesh, donate=True)
        batch = batch_at(arch, 0)
        s1, s2 = one.init_state(7), on.init_state(7)
        pairs = list(zip(tree_leaves(s1.params) + tree_leaves(s1.opt_state),
                         tree_leaves(s2.params) + tree_leaves(s2.opt_state)))
        res[f"{arch}/init_state_equal"] = np.array(
            [torch.equal(full(b), a) for a, b in pairs])
        res[f"{arch}/init_state_placed"] = np.array(
            [hasattr(b, "device_mesh") for _, b in pairs])
        l1, g1 = one.grad_fn(params, batch)
        _, m1 = one.step_fn(state_of(params, one, ocfg), batch)
        p2 = placed(params, on)
        n0 = len(calls)
        l2, g2 = on.grad_fn(p2, batch)
        res[f"{arch}/moe_sharded_calls"] = np.array(len(calls) - n0)
        res[f"{arch}/grad_placements_ok"] = np.array(all(
            g.placements == p.placements
            for g, p in zip(tree_leaves(g2), tree_leaves(p2))))
        _, m2 = on.step_fn(state_of(p2, on, ocfg), batch)
        res[f"{arch}/one"] = np.array([float(l1), float(m1["loss"]),
                                       float(m1["grad_norm"])])
        res[f"{arch}/mesh"] = np.array([float(l2), float(m2["loss"]),
                                        float(m2["grad_norm"])])
        for path, a, b in zip(paths(g1), tree_leaves(g1), tree_leaves(g2)):
            res[f"{arch}/grad_one{path}"] = a.numpy()
            res[f"{arch}/grad_mesh{path}"] = full(b).numpy()
    if "ada" in job:
        ada = job["ada"]
        cfg = get_smoke_config(ada["arch"])
        model = build_model(cfg)
        ocfg = OptConfig(name="adafactor",
                         factored_min_dim=ada["factored_min_dim"],
                         **job["opt"])
        params = tree(f"{ada['arch']}/params/")
        for name, kw in (("one", {}), ("mesh", {"mesh": mesh})):
            setup = make_train_step(model, ocfg, ada["accum"], CPU,
                                    donate=bool(kw), **kw)
            p = params if not kw else placed(params, setup)
            state = state_of(p, setup, ocfg)
            losses = []
            for i in range(ada["steps"]):
                state, m = setup.step_fn(state, batch_at(ada["arch"], i))
                losses.append(float(m["loss"]))
            res[f"ada/{name}"] = np.array(losses)
        try:
            setup.step_fn(state, {k: v[:6] for k, v in batch_at(
                ada["arch"], 0).items()})
            res["ada/refused"] = np.array("")
        except ValueError as err:
            res["ada/refused"] = np.array(str(err))
    if job.get("fall"):
        from repro_torch.launch import train as train_mod
        out = train_mod.main(["--arch", "rwkv6_1b6", "--smoke", "--steps",
                              "30", "--batch", "8", "--seq", "32", "--lr",
                              "5e-3", "--log-every", "10", "--device", CPU])
        res["fall/losses"] = np.array(out.losses)
        res["fall/mesh"] = np.array(
            out.state.params["head"].device_mesh.mesh.shape)
    for V in job.get("ce", []):
        for x_spec in ((None, None, None), ("data", None, None)):
            ce_case(mesh, V, x_spec)
        for layout in EMB_LAYOUTS:
            embed_case(mesh, V, layout)
elif job["kind"] == "ce":
    mesh = make_debug_mesh(data=1, model=2)
    for V in job["ce"]:
        ce_case(mesh, V, (None, None, None))
        embed_case(mesh, V, "vocab")
else:
    from repro_torch.train.compression import (make_compressed_allreduce,
                                               quantize_leaf)
    from repro_torch.train.pipeline import pipelined_forward
    mesh = make_debug_mesh(data=2, model=2, pod=2)
    res["pod"] = np.array(mesh.get_local_rank("pod"))
    comp = {k: torch.from_numpy(inp[f"comp/{k}"]) for k in ("a", "b", "c")}
    zeros = {k: torch.zeros_like(v) for k, v in comp.items()}
    errs = dict(zeros, c=torch.from_numpy(inp["comp/e_c"]))
    for tag, e in (("zero", zeros), ("carried", errs)):
        for k in comp:
            q, s, ne = quantize_leaf(comp[k], e[k])
            res[f"quant/{tag}/{k}/q"] = q.numpy()
            res[f"quant/{tag}/{k}/scale"] = s.numpy()
            res[f"quant/{tag}/{k}/error"] = ne.numpy()
    ar = make_compressed_allreduce(mesh)
    err = zeros
    acc = {k: torch.zeros_like(v) for k, v in comp.items()}
    for i in range(20):
        g, err = ar(comp, err)
        if i == 0:
            for k in comp:
                res[f"allreduce/{k}/g"] = g[k].numpy()
                res[f"allreduce/{k}/e"] = err[k].numpy()
        acc = {k: acc[k] + g[k] for k in comp}
    for k in comp:
        res[f"allreduce/{k}/mean20"] = (acc[k] / 20).numpy()
    # each pod holds its own gradient: the mean over pods
    mine = {k: v * (1.0 + mesh.get_local_rank("pod")) for k, v in
            comp.items()}
    g, _ = ar(mine, zeros)
    for k in comp:
        res[f"allreduce/{k}/pods"] = g[k].numpy()
        q, s, _ = quantize_leaf(2.0 * comp[k], zeros[k])
        res[f"allreduce/{k}/pods_want"] = (q.float() * s).numpy()

    def stage_fn(sp, h):
        for w in sp["w"]:
            h = torch.tanh(h @ w)
        return h
    w = torch.from_numpy(inp["pipe/w"]).requires_grad_()
    x = torch.from_numpy(inp["pipe/x"])
    wt = torch.from_numpy(inp["pipe/wt"])
    y = pipelined_forward(mesh, stage_fn, job["pipe"]["M"])({"w": w}, x)
    (y * wt).sum().backward()
    res["pipe/y"] = y.detach().numpy()
    res["pipe/grad"] = w.grad.numpy()
    ws = torch.from_numpy(inp["pipe/w"]).requires_grad_()
    h = x
    for s in range(job["pipe"]["S"]):
        h = stage_fn({"w": ws[s]}, h)
    (h * wt).sum().backward()
    res["pipe/seq_y"] = h.detach().numpy()
    res["pipe/seq_grad"] = ws.grad.numpy()
np.savez(out_path, **res)
dist.destroy_process_group()
"""


def _start_ranks(tmp, name, world, job, env):
    init = tmp / f"rendezvous_{name}"
    return [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(RANK), str(r), str(world),
         str(init), str(tmp / f"{name}_rank{r}.npz"),
         str(tmp / "inputs.npz"), json.dumps(job)],
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
    """The reference (8 host devices) and the two four-rank worlds at once,
    then the eight ranks and the two: {"ref": ..., "a": [per rank],
    "b": ..., "pod": ..., "ce": ...}."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    make_inputs(tmp / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    ref_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref_job = {"archs": ARCHS, "opt": OPT, "ada": ADA, "pipe": PIPE}
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         str(tmp / "inputs.npz"), str(tmp / "reference.npz"), repr(ref_job)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=ref_env)
    jobs = {"a": {"kind": "families", "archs": WORLDS["a"], "opt": OPT,
                  "fall": True, "ce": CE_VOCABS},
            "b": {"kind": "families", "archs": WORLDS["b"], "opt": OPT,
                  "ada": ADA}}
    try:
        procs = [p for name, job in jobs.items()
                 for p in _start_ranks(tmp, name, 4, job, env)]
        _wait(procs)
    finally:
        _wait([ref])
    _wait(_start_ranks(tmp, "pod", 8, {"kind": "pod", "pipe": PIPE}, env)
          + _start_ranks(tmp, "ce", 2, {"kind": "ce", "ce": CE_VOCABS},
                         env))
    load = lambda name: dict(np.load(tmp / name))
    out = {"ref": load("reference.npz")}
    for name, world in (("a", 4), ("b", 4), ("pod", 8), ("ce", 2)):
        out[name] = [load(f"{name}_rank{r}.npz") for r in range(world)]
    return out


def _world(arch):
    return next(k for k, archs in WORLDS.items() if arch in archs)


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_init_state_equals_one_device(runs, arch):
    """``init_state(7)`` on the (2, 2) mesh (each rank drawing its blocks
    of the keyed stream through ``param_placer``, the moments made as
    blocks) against the one-device ``init_state(7)``: every parameter and
    moment bit for bit, each a ``DTensor``, on every rank."""
    for r in runs[_world(arch)]:
        assert r[f"{arch}/init_state_equal"].size > 0
        assert r[f"{arch}/init_state_equal"].all()
        assert r[f"{arch}/init_state_placed"].all()


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_the_reference(runs, arch):
    """One step on (2, 2) from the same parameters and batch: the loss and
    ``grad_norm`` within 1e-5 relative of the reference's
    ``make_train_step`` on its (2, 2) mesh, every gradient within 1e-5 of
    its leaf's max|g| of ``jax.grad`` of the reference's loss, every
    gradient in its parameter's placements, every rank the same."""
    ranks, ref = runs[_world(arch)], runs["ref"]
    r0 = ranks[0]
    loss, step_loss, gnorm = r0[f"{arch}/mesh"]
    np.testing.assert_allclose(loss, ref[f"{arch}/value"], rtol=TOL)
    np.testing.assert_allclose(step_loss, ref[f"{arch}/loss"], rtol=TOL)
    np.testing.assert_allclose(gnorm, ref[f"{arch}/grad_norm"], rtol=TOL)
    grads = [k for k in r0 if k.startswith(f"{arch}/grad_mesh/")]
    want = {k for k in ref if k.startswith(f"{arch}/grad/")}
    assert {k.replace("grad_mesh", "grad") for k in grads} == want
    for k in grads:
        _close(r0[k], ref[k.replace("grad_mesh", "grad")], TOL, k)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[k], r0[k])
    assert all(bool(r[f"{arch}/grad_placements_ok"]) for r in ranks)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_one_device(runs, arch):
    """The same step on one device: loss, ``grad_norm`` (a replicated leaf
    counted once, not once a rank, which would inflate it by up to the
    world size) and every gradient within 1e-5."""
    r0 = runs[_world(arch)][0]
    np.testing.assert_allclose(r0[f"{arch}/mesh"], r0[f"{arch}/one"],
                               rtol=TOL)
    for k in (k for k in r0 if k.startswith(f"{arch}/grad_mesh/")):
        _close(r0[k], r0[k.replace("grad_mesh", "grad_one")], TOL, k)


def test_moe_trains_on_the_expert_parallel_path(runs):
    """The MoE config's step on (2, 2) takes the expert-parallel path (8
    experts over 'model'; at 4 x 8 tokens, below the reference's 4096, its
    gathered-token variant ``moe_ffn_sharded_decode``) in every MoE layer,
    and its loss is the one-device loss's within 1e-5."""
    r0 = runs[_world(MOE_ARCH)][0]
    cfg = get_smoke_config(MOE_ARCH)
    assert int(r0[f"{MOE_ARCH}/moe_sharded_calls"]) == cfg.num_layers
    np.testing.assert_allclose(r0[f"{MOE_ARCH}/mesh"][0],
                               r0[f"{MOE_ARCH}/one"][0], rtol=TOL)


def test_adafactor_with_accumulation_on_the_mesh(runs):
    """Adafactor (factored moments on split leaves) with ``grad_accum=2``
    on stablelm_12b, three donated steps on (2, 2): the loss curve within
    1e-4 of the reference's trainer on its mesh and of the one-device step;
    a batch whose rows on a rank ``grad_accum`` does not divide is
    refused."""
    r0 = runs["b"][0]
    np.testing.assert_allclose(r0["ada/mesh"], runs["ref"]["ada/losses"],
                               rtol=CURVE_TOL)
    np.testing.assert_allclose(r0["ada/mesh"], r0["ada/one"], rtol=CURVE_TOL)
    assert "grad_accum=2 must divide" in str(r0["ada/refused"])


def test_train_loss_decreases_on_mesh(runs):
    """The reference's test_train_loss_decreases_on_mesh on the port:
    ``launch.train`` of the smoke RWKV, 30 steps at batch 8, seq 32, lr
    5e-3 on four gloo ranks ((2, 2) mesh): the last loss below the first by
    more than 0.2, every rank the same losses."""
    ranks = runs["a"]
    losses = ranks[0]["fall/losses"]
    assert list(ranks[0]["fall/mesh"]) == [2, 2]
    assert len(losses) == 30 and losses[-1] < losses[0] - 0.2, losses
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["fall/losses"], losses)


@pytest.mark.parametrize("world,x_split", [("ce", "whole"), ("a", "whole"),
                                           ("a", "split")])
@pytest.mark.parametrize("vocab", CE_VOCABS)
def test_vocab_parallel_cross_entropy(runs, world, x_split, vocab):
    """``chunked_ce_loss`` with the output table's vocab split over 'model'
    on (1, 2) and (2, 2) (x whole, or its batch over 'data'): loss and the
    gradients of x and of the table within 1e-6 relative of the one-device
    loss's, at a vocab 'model' divides (32: each rank's block, the gold
    logit gathered where the label falls in it, summed over 'model') and
    one it does not (33). Before the fix the gather of the gold logits on
    a vocab-split mesh failed in DTensor's mask buffer."""
    tag = f"ce/{vocab}/{x_split}"
    for r in runs[world]:
        one, got = r[f"{tag}/loss"]
        np.testing.assert_allclose(got, one, rtol=CE_TOL)
        for name in ("x", "embed"):
            _close(r[f"{tag}/{name}/mesh"], r[f"{tag}/{name}/one"], CE_TOL,
                   name)


@pytest.mark.parametrize("world,layout", [("ce", "vocab"), ("a", "vocab"),
                                          ("a", "vocab_embed"),
                                          ("a", "zero")])
@pytest.mark.parametrize("vocab", CE_VOCABS)
def test_vocab_parallel_embedding_lookup(runs, world, layout, vocab):
    """``layers.embed_lookup`` on a table whose vocab is split over 'model'
    on (1, 2) and (2, 2) (``vocab``), its d_model over 'data' as well
    (``vocab_embed``, FSDP), or its vocab over both axes (``zero``), the
    tokens' batch over 'data': each rank looks its tokens up in its block
    of rows and the rows are summed over the vocab axes. The rows equal the
    one-device lookup bit for bit and the table's gradient is within 1e-6
    of its gradient, at a vocab the split divides (32) and one it does not
    (33). Before it the lookup gathered the whole table (the dry run: 5.06
    GB a rank at qwen2_72b's (32, 8) decode) and its backward was the
    ``index_put`` PyTorch 2.11's DTensor refuses."""
    tag = f"emb/{vocab}/{layout}"
    for r in runs[world]:
        np.testing.assert_array_equal(r[f"{tag}/out/mesh"],
                                      r[f"{tag}/out/one"])
        _close(r[f"{tag}/grad/mesh"], r[f"{tag}/grad/one"], CE_TOL,
               "embed")


def test_compression_meets_the_reference_criteria(runs):
    """The reference's test_gradient_compression_error_feedback on (pod 2,
    data 2, model 2): identical inputs on both pods give their mean to
    1/100 of max|x|, the error is at most one quantisation step, and the
    average over 20 steps with error feedback is within 2e-3. Pods with
    different gradients (x and 2x) quantise to the same int8 payload under
    their own scales; the sum is rescaled by the larger scale, so the
    result is 2x's dequantised value, not the mean 1.5x (the reference's
    shared-max-scale rule, kept)."""
    for r in runs["pod"]:
        for k in ("a", "b"):
            x = r[f"allreduce/{k}/g"]
            want = {"a": np.linspace(-1, 1, 64, dtype=np.float32).reshape(
                8, 8), "b": np.array([1e-3, 5.0, -2.0], np.float32)}[k]
            top = float(np.abs(want).max())
            np.testing.assert_allclose(x, want, atol=top / 100)
            assert float(np.abs(r[f"allreduce/{k}/e"]).max()) \
                <= top / 127 + 1e-6
            np.testing.assert_allclose(r[f"allreduce/{k}/mean20"], want,
                                       atol=2e-3 * max(1.0, top))
            np.testing.assert_array_equal(r[f"allreduce/{k}/pods"],
                                          r[f"allreduce/{k}/pods_want"])


def test_compression_is_the_reference_bit_for_bit(runs):
    """``quantize_leaf``'s q, scale and error equal the reference's (run
    op by op) bit for bit, with and without a carried error, on a leaf with
    elements at exactly x.5 steps (both round half to even: 0.5 -> 0, 1.5
    -> 2, 2.5 -> 2, -3.5 -> -4). The all-reduce over 'pod' gives the
    reference's jitted gradients bit for bit and its errors within 2^-16 of
    a step: XLA fuses ``g - q * scale`` into one multiply-add, whose
    rounding differs (the reference's jitted and op-by-op errors differ
    alike)."""
    ref = runs["ref"]
    for r in runs["pod"]:
        for k in (k for k in ref if k.startswith("quant/")
                  or k.endswith("/g")):
            np.testing.assert_array_equal(r[k], ref[k], err_msg=k)
        for k in (k for k in ref if k.startswith("allreduce/")
                  and k.endswith("/e")):
            leaf = k.split("/")[1]
            step = float(ref[f"quant/zero/{leaf}/scale"])
            np.testing.assert_allclose(r[k], ref[k], rtol=0,
                                       atol=step * 2.0 ** -16, err_msg=k)
    q = runs["pod"][0]["quant/zero/c/q"]
    assert q.tolist() == [127, 0, 2, 2, 0, -4, 3]


def test_compression_needs_a_pod_axis():
    with pytest.raises(ValueError, match="'pod' mesh axis"):
        make_compressed_allreduce(types.SimpleNamespace(
            shape={"data": 2, "model": 2}))


def test_pipeline_matches_the_sequential_stack_and_the_reference(runs):
    """The reference's test_pipeline_parallel_matches_sequential on the
    port (S = 2 stages over 'pod', 3 layers a stage, D = 16, M = 4): the
    output within rtol = atol = 1e-5 of the sequential stack and of the
    reference's ``pipelined_forward``; the gradient of sum(y * w) with
    respect to each stage's weights within 1e-5 of the sequential stack's
    and of ``jax.grad`` through the reference's (each rank holds its own
    stage's, zeros elsewhere)."""
    ref = runs["ref"]
    for r in runs["pod"]:
        np.testing.assert_allclose(r["pipe/y"], r["pipe/seq_y"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["pipe/y"], ref["pipe/y"], rtol=1e-5,
                                   atol=1e-5)
        s = int(r["pod"])
        np.testing.assert_allclose(r["pipe/grad"][s], r["pipe/seq_grad"][s],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["pipe/grad"][s], ref["pipe/grad"][s],
                                   rtol=1e-5, atol=1e-5)
        assert not np.any(r["pipe/grad"][1 - s])
