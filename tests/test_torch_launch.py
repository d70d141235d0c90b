"""PyTorch port, the LM zoo's entry points (``repro_torch.launch``), its
one-device train and serve steps with the RWKV model, and bfloat16
checkpoints (``repro_torch.checkpoint``), held against ``repro`` where the
reference runs on the CPU.

The trainer: five steps of the smoke RWKV from the reference's parameters
(carried across) on the reference's token stream, within 1e-4 of the
reference's trainer on a 1 x 1 debug mesh (float32; gradients through
autograd on one side and ``jax.grad`` on the other). A resumed
``launch.train`` run gives the losses of an uninterrupted one to 1e-6.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.models as ref_models  # noqa: E402
import repro.train.optimizers as ref_opt  # noqa: E402
from repro.checkpoint import CheckpointManager as RefCheckpointManager  # noqa
from repro.data import TokenPipeline  # noqa: E402
from repro.distributed.sharding import TP_RULES  # noqa: E402
from repro.launch.mesh import make_debug_mesh  # noqa: E402
from repro.train.trainer import TrainState as RefTrainState  # noqa: E402
from repro.train.trainer import make_train_step as ref_make_train_step  # noqa
from repro_torch import tree_from_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import _flatten  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import (OptConfig, TrainState,  # noqa: E402
                               init_opt_state, make_serve_steps,
                               make_train_step)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
TRAIN_TOL = 1e-4
RESUME_TOL = 1e-6
OPT = dict(peak_lr=3e-3, warmup_steps=2, decay_steps=10, weight_decay=0.1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _close(ours, ref, tol, path=""):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), path
        for k in ref:
            _close(ours[k], ref[k], tol, f"{path}/{k}")
        return
    want = np.asarray(ref)
    np.testing.assert_allclose(ours.detach().numpy(), want, rtol=0,
                               err_msg=path,
                               atol=tol * max(1.0, float(np.abs(want).max())))


# --------------------------------------------------------------------------
# bfloat16 checkpoints
# --------------------------------------------------------------------------
def _bf16_tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn((4, 3), generator=g).to(torch.bfloat16),
            "b": {"x": torch.randn(5, generator=g).to(torch.bfloat16),
                  "f": torch.randn(2, generator=g)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_bf16_checkpoint_round_trips_bit_for_bit(tmp_path):
    """A bf16 leaf is saved as the reference saves it (2-byte |V2 records
    of the raw bits) and restored into a bf16 template by reinterpreting
    the bytes: the same bits. Before the fix the save raised TypeError."""
    tree = _bf16_tree()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, tree)
    with np.load(tmp_path / "step_0000000003" / "state.npz") as z:
        assert z["w"].dtype == np.dtype("V2") and z["b//f"].dtype == np.float32
        np.testing.assert_array_equal(
            z["w"].view(np.int16), tree["w"].view(torch.int16).numpy())
    template = {"w": torch.zeros((4, 3), dtype=torch.bfloat16),
                "b": {"x": torch.zeros(5, dtype=torch.bfloat16),
                      "f": torch.zeros(2)},
                "step": torch.tensor(0, dtype=torch.int32)}
    back = mgr.restore(template)
    for a, b in zip(_leaves(tree), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # into a float32 template: the bf16 values, cast
    as32 = mgr.restore({**template, "w": torch.zeros((4, 3))})
    assert torch.equal(as32["w"], tree["w"].float())


def test_bf16_checkpoint_written_by_the_reference_restores(tmp_path):
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16)
    RefCheckpointManager(str(tmp_path), async_save=False).save(
        5, {"w": w, "v": jnp.arange(3, dtype=jnp.float32)})
    back = CheckpointManager(str(tmp_path)).restore(
        {"w": torch.zeros((3, 4), dtype=torch.bfloat16),
         "v": torch.zeros(3)})
    assert back["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["w"].float().numpy(),
                                  np.asarray(w, np.float32))
    np.testing.assert_array_equal(back["v"].numpy(), np.arange(3))


# --------------------------------------------------------------------------
# the trainer and the serve steps with the RWKV model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("chunk,seq,grad_accum", [(0, 12, 1), (16, 32, 2)])
def test_five_rwkv_train_steps_match_reference(chunk, seq, grad_accum):
    """Five steps of make_train_step on the smoke RWKV from the reference's
    initial parameters, on the token stream: every parameter, every moment
    and each step's loss within TRAIN_TOL of the reference's trainer."""
    cfg = get_smoke_config("rwkv6_1b6").replace(rwkv_chunk=chunk)
    rcfg = ref_configs.get_smoke_config("rwkv6_1b6").replace(rwkv_chunk=chunk)
    model, rmodel = build_model(cfg), ref_models.build_model(rcfg)
    params = rmodel.init(jax.random.PRNGKey(0))
    ocfg, rocfg = OptConfig(**OPT), ref_opt.OptConfig(**OPT)
    mesh = make_debug_mesh(data=1, model=1)
    rsetup = ref_make_train_step(rmodel, mesh, opt_cfg=rocfg,
                                 grad_accum=grad_accum, rules=TP_RULES)
    setup = make_train_step(model, opt_cfg=ocfg, grad_accum=grad_accum,
                            device=CPU)
    ours = TrainState(params=tree_from_numpy(jax.tree_util.tree_map(
        np.asarray, params), device=CPU), opt_state=None,
        step=torch.zeros((), dtype=torch.int32))
    ours = ours._replace(opt_state=init_opt_state(ours.params, ocfg))
    ref = RefTrainState(params=params,
                        opt_state=ref_opt.init_opt_state(params, rocfg),
                        step=jnp.zeros((), jnp.int32))
    pipe = TokenPipeline(cfg.vocab_size, 4, seq)
    with mesh:
        for step in range(5):
            tokens, labels = pipe.batch_at(step)
            ours, m = setup.step_fn(ours, {"tokens": torch.from_numpy(tokens),
                                           "labels": torch.from_numpy(labels)})
            ref, rm = rsetup.step_fn(ref, {"tokens": jnp.asarray(tokens),
                                           "labels": jnp.asarray(labels)})
            np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                       rtol=TRAIN_TOL)
    assert int(ours.step) == int(ref.step) == 5
    _close(ours.params, ref.params, TRAIN_TOL)
    _close(ours.opt_state, ref.opt_state, TRAIN_TOL)


def test_serve_steps_are_the_models_without_autograd():
    cfg = get_smoke_config("rwkv6_1b6")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    for p in _leaves(params):
        p.requires_grad_()
    serve = make_serve_steps(model, max_len=16, device=CPU)
    assert serve["device"] == torch.device("cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(1))
    logits, cache = serve["prefill"](params, {"tokens": tokens})
    with torch.no_grad():
        want, wcache = model.prefill(params, {"tokens": tokens})
    assert not logits.requires_grad and torch.equal(logits, want)
    for a, b in zip(cache, wcache):
        assert torch.equal(a, b)
    nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
    logits, cache = serve["decode_step"](params, cache, nxt)
    with torch.no_grad():
        want, _ = model.decode_step(params, wcache, nxt)
    assert not logits.requires_grad and torch.equal(logits, want)
    assert int(cache.length) == 10


# --------------------------------------------------------------------------
# launch/train.py
# --------------------------------------------------------------------------
TRAIN_ARGS = ["--arch", "rwkv6_1b6", "--smoke", "--steps", "6", "--batch",
              "4", "--seq", "16", "--log-every", "100", "--device", CPU]


def test_train_resumed_from_a_checkpoint_replays_the_stream(tmp_path):
    """A run preempted at step 3 (a subprocess killed by
    --simulate-preempt, checkpoint every 3 steps) and resumed gives the
    uninterrupted run's losses at steps 3-5; the final states agree."""
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGS,
         "--ckpt-dir", ckpt, "--ckpt-every", "3", "--simulate-preempt", "3"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)
    assert proc.returncode == 42, proc.stderr[-2000:]
    assert "SIMULATED PREEMPTION at step 3" in proc.stdout
    resumed = train_mod.main(TRAIN_ARGS + ["--ckpt-dir", ckpt])
    assert resumed.start_step == 3 and len(resumed.losses) == 3
    whole = train_mod.main(TRAIN_ARGS)
    assert whole.start_step == 0 and len(whole.losses) == 6
    np.testing.assert_allclose(resumed.losses, whole.losses[3:],
                               rtol=RESUME_TOL)
    assert int(resumed.state.step) == int(whole.state.step) == 6
    _close(resumed.state.params, tree_to_ref(whole.state.params), RESUME_TOL)
    # the run saved its last state at --steps
    assert CheckpointManager(ckpt).latest_step() == 6


def test_checkpoint_saved_mid_run_holds_its_step(tmp_path, monkeypatch):
    """A 5-step run with --device cpu saving every 2 steps keeps in its
    step-2 checkpoint the state of a 2-step run, bit for bit. The step-2
    write is held back on its background thread until the donated steps 3
    and 4 have rewritten the parameters and moments in place. The first two
    steps are in the warmup, whose learning rate does not depend on
    --steps."""
    write = CheckpointManager._write

    def late_write(self, step, host, extra):
        if step == 2:
            time.sleep(1.0)
        write(self, step, host, extra)

    monkeypatch.setattr(CheckpointManager, "_write", late_write)
    ckpt = str(tmp_path / "ckpt")
    args = ["--arch", "rwkv6_1b6", "--smoke", "--batch", "4", "--seq", "16",
            "--log-every", "100", "--device", CPU]
    train_mod.main(args + ["--steps", "5", "--ckpt-dir", ckpt,
                           "--ckpt-every", "2", "--keep", "5"])
    two = train_mod.main(args + ["--steps", "2"])
    assert CheckpointManager(ckpt).all_steps() == [2, 4, 5]
    saved = CheckpointManager(ckpt).restore(two.state, step=2)
    assert int(saved.step) == 2
    want, got = _flatten(two.state), _flatten(saved)
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def tree_to_ref(tree):
    return {k: tree_to_ref(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def test_train_loss_decreases():
    """The reference's test_train_loss_decreases_on_mesh, on the port."""
    res = train_mod.main(["--arch", "rwkv6_1b6", "--smoke", "--steps", "30",
                          "--batch", "8", "--seq", "32", "--lr", "5e-3",
                          "--log-every", "10", "--device", CPU])
    assert res.losses[-1] < res.losses[0] - 0.2, (res.losses[0],
                                                  res.losses[-1])
    assert np.isfinite(res.ms_per_step) and res.ms_per_step > 0


@pytest.mark.parametrize("mod", [train_mod, serve_mod])
def test_multi_card_mesh_is_refused(mod):
    """The trainer's and the server's multi-node mesh over a world of one
    (no process group) name the ranks they need."""
    argv = ["--arch", "rwkv6_1b6", "--smoke", "--mesh", "multi", "--device",
            CPU]
    with pytest.raises(ValueError, match="multiple of 16 ranks"):
        mod.main(argv)


CKPT_ARGS = ["--arch", "stablelm_12b", "--smoke", "--steps", "8", "--batch",
             "4", "--seq", "16", "--ckpt-every", "2", "--log-every", "100",
             "--device", CPU]

LAUNCH_RANK = """
import os
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
out, init, resume_dir, whole_dir = sys.argv[1:5]
argv = sys.argv[5:]
dist.init_process_group("gloo", init_method="file://" + init,
                        rank=int(os.environ["RANK"]), world_size=4)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import full_value
from repro_torch.launch import train
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model
from repro_torch.train import make_train_step

res = {}
# the one-process run's step-4 checkpoint restored onto the (2, 2) mesh
mesh = make_debug_mesh(data=2, model=2)
setup = make_train_step(build_model(get_smoke_config("stablelm_12b")),
                        device="cpu", mesh=mesh)
back = CheckpointManager(resume_dir, mesh=mesh).restore(
    setup.init_state(0), step=4, shardings=setup.state_shardings)
for k, v in _flatten(back).items():
    res["at4/" + k] = full_value(v).numpy()
    res["at4_dtensor/" + k] = np.array(hasattr(v, "device_mesh"))
resumed = train.main(argv + ["--ckpt-dir", resume_dir])
res["resumed"] = np.array(resumed.losses)
res["resumed_start"] = np.array(resumed.start_step)
whole = train.main(argv + ["--ckpt-dir", whole_dir])
res["whole"] = np.array(whole.losses)
for k, v in _flatten(whole.state).items():
    res["final/" + k] = full_value(v).numpy()
try:
    train.main(argv + ["--mesh", "multi"])
    res["multi"] = np.array("")
except ValueError as err:
    res["multi"] = np.array(str(err))
np.savez(out, **res)
dist.destroy_process_group()
"""


def test_checkpoint_restart_and_elastic_restore(tmp_path):
    """The reference's test_checkpoint_restart_and_elastic_restore on the
    port: stablelm_12b smoke, 8 steps at batch 4, seq 16, a checkpoint
    every 2, preempted at step 4 in one process (exit 42); resumed on four
    gloo ranks ((2, 2) mesh) it prints "restored checkpoint at step 4" and
    "final loss" (rank 0 alone), and its losses equal an uninterrupted
    four-rank run's within 1e-6. The step-4 checkpoint one process wrote
    restores onto the mesh as ``DTensor`` s holding its values bit for bit,
    the step-8 checkpoint four ranks wrote restores in one process bit for
    bit, and ``--mesh multi`` on four ranks names the 16 it needs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    resume, whole = tmp_path / "resume", tmp_path / "whole"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *CKPT_ARGS,
         "--ckpt-dir", str(resume), "--simulate-preempt", "4"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)
    assert proc.returncode == 42, proc.stderr[-2000:]
    assert "SIMULATED PREEMPTION at step 4" in proc.stdout
    procs = [subprocess.Popen(
        [sys.executable, "-c", LAUNCH_RANK, str(tmp_path / f"rank{r}.npz"),
         str(tmp_path / "rendezvous"), str(resume), str(whole), *CKPT_ARGS],
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert "restored checkpoint at step 4" in outs[0], outs[0]
    assert "final loss" in outs[0]
    assert all("final loss" not in o and "restored" not in o
               for o in outs[1:])
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    r0 = ranks[0]
    assert int(r0["resumed_start"]) == 4 and len(r0["resumed"]) == 4
    np.testing.assert_allclose(r0["resumed"], r0["whole"][4:],
                               rtol=RESUME_TOL)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["whole"], r0["whole"])
    with np.load(resume / "step_0000000004" / "state.npz") as z:
        saved = {k: z[k] for k in z.files}
    keys = [k[len("at4/"):] for k in r0 if k.startswith("at4/")]
    assert set(keys) == set(saved)
    for k in keys:
        np.testing.assert_array_equal(r0["at4/" + k], saved[k], err_msg=k)
        assert bool(r0["at4_dtensor/" + k]) == (k != ".step"), k
    model = build_model(get_smoke_config("stablelm_12b"))
    template = make_train_step(model, device=CPU).init_state(0)
    back = CheckpointManager(str(whole)).restore(template)
    assert int(back.step) == 8
    for k, v in _flatten(back).items():
        assert not hasattr(v, "device_mesh")
        np.testing.assert_array_equal(v.numpy(), r0["final/" + k],
                                      err_msg=k)
    assert "multiple of 16 ranks" in str(r0["multi"])


def test_distributed_serving_example_on_four_gloo_ranks():
    """examples/torch_distributed_serving.py --device cpu: four gloo ranks
    serve the reference example's sizes on a (2, 2) mesh and print its
    lines."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_distributed_serving.py"),
         "--device", CPU], capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "mesh={'data': 2, 'model': 2} served batch=8" in proc.stdout
    assert "generated=24 tokens/request" in proc.stdout
    assert "OK: batched serving on the mesh." in proc.stdout


SERVE_RANK = """
import os, sys
import numpy as np
from repro_torch.launch import serve
res = serve.main(sys.argv[2:])
np.save(sys.argv[1], res.tokens)
"""


@pytest.mark.parametrize("arch", ["stablelm_12b", "qwen3_moe_235b"])
def test_serve_on_a_debug_mesh_of_four_gloo_ranks(tmp_path, arch):
    """``launch.serve --mesh debug --smoke --device cpu`` in four processes
    that ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` and a ``file://``
    rendezvous name: a (2, 2) mesh, the parameters drawn leaf by leaf and
    placed, the MoE on its expert-parallel path; every rank's greedy tokens
    equal the one-device serve's."""
    argv = ["--arch", arch, "--smoke", "--batch", "4", "--prompt-len", "8",
            "--gen", "6", "--mesh", "debug", "--device", CPU]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", WORLD_SIZE="4",
               DIST_INIT_METHOD=f"file://{tmp_path / 'rendezvous'}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", SERVE_RANK, str(tmp_path / f"rank{r}.npy"),
         *argv], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    want = serve_mod.serve_lm(get_smoke_config(arch), 4, 8, 6, 0, CPU).tokens
    for r in range(4):
        np.testing.assert_array_equal(np.load(tmp_path / f"rank{r}.npy"),
                                      want)


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "whisper_tiny"])
def test_train_runs_the_hybrid_and_the_encoder_decoder(arch):
    """--smoke --device cpu for the Griffin hybrid and the encoder-decoder
    (zero float32 frames, as the reference's launcher): finite losses that
    fall at the smoke widths."""
    res = train_mod.main(["--arch", arch, "--smoke", "--steps", "8",
                          "--batch", "4", "--seq", "16", "--lr", "5e-3",
                          "--log-every", "100", "--device", CPU])
    assert len(res.losses) == 8 and np.all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0]


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "whisper_tiny"])
def test_serve_lm_mode_runs_the_hybrid_and_the_encoder_decoder(arch):
    """The hybrid's prompt (12) runs past its window (8) and its decode
    wraps the buffer; the encoder-decoder's prefill takes zero frames. The
    same tokens on a second run; serve_lm is main's loop."""
    args = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "12",
            "--gen", "4", "--device", CPU]
    res = serve_mod.main(args)
    assert res.tokens.shape == (2, 4) and res.tokens_per_s > 0
    cfg = get_smoke_config(arch)
    assert ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()
    np.testing.assert_array_equal(serve_mod.main(args).tokens, res.tokens)
    again = serve_mod.serve_lm(cfg, 2, 12, 4, device=CPU)
    np.testing.assert_array_equal(again.tokens, res.tokens)


@pytest.mark.parametrize("arch", ["llava_next_mistral_7b", "qwen3_moe_235b"])
def test_train_runs_the_decoder_family(arch):
    """--smoke --device cpu for the VLM (zero patch embeddings as its
    prefix, as the reference's launcher) and the MoE: finite losses that
    fall at the smoke widths."""
    res = train_mod.main(["--arch", arch, "--smoke", "--steps", "8",
                          "--batch", "4", "--seq", "16", "--lr", "5e-3",
                          "--log-every", "100", "--device", CPU])
    assert len(res.losses) == 8 and np.all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0]


@pytest.mark.parametrize("arch", ["llava_next_mistral_7b", "qwen3_moe_235b"])
def test_serve_lm_mode_runs_the_decoder_family(arch):
    """The VLM's prefill takes its patch prefix into the cache; the same
    tokens on a second run; serve_lm is main's loop."""
    args = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "8",
            "--gen", "3", "--device", CPU]
    res = serve_mod.main(args)
    assert res.tokens.shape == (2, 3) and res.tokens_per_s > 0
    np.testing.assert_array_equal(serve_mod.main(args).tokens, res.tokens)
    again = serve_mod.serve_lm(get_smoke_config(arch), 2, 8, 3, device=CPU)
    np.testing.assert_array_equal(again.tokens, res.tokens)


def test_serve_steps_carry_the_vlm_prefix():
    """make_serve_steps moves prefix_embeds to the device with the tokens;
    the cache holds max_len positions, the prefix counted."""
    cfg = get_smoke_config("llava_next_mistral_7b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    max_len = cfg.num_patch_tokens + 8 + 2
    serve = make_serve_steps(model, max_len=max_len, device=CPU)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8), generator=g),
             "prefix_embeds": torch.randn((2, cfg.num_patch_tokens,
                                           cfg.d_model), generator=g)}
    logits, cache = serve["prefill"](params, batch)
    assert cache.k.shape[2] == max_len
    assert int(cache.length) == cfg.num_patch_tokens + 8
    with torch.no_grad():
        want, _ = model.prefill(params, batch, max_len)
        no_prefix, _ = model.prefill(params, {"tokens": batch["tokens"]},
                                     max_len)
    assert torch.equal(logits, want) and not torch.equal(logits, no_prefix)
    with pytest.raises(ValueError, match="max_len"):
        make_serve_steps(model, max_len=9, device=CPU)["prefill"](params,
                                                                  batch)


@pytest.mark.parametrize("arch,optimizer", [("qwen3_moe_235b", "adamw"),
                                            ("stablelm_12b", "adamw"),
                                            ("stablelm_12b", "adafactor")])
def test_donated_train_step_updates_in_place(arch, optimizer, monkeypatch):
    """make_train_step(donate=True): the state's own tensors take the new
    values (chunked AdamW, here in chunks of 1000 elements), which equal
    the functional step's to 1e-6."""
    import repro_torch.train.optimizers as opt_mod
    monkeypatch.setattr(opt_mod, "DONATE_CHUNK", 1000)
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    opt = OptConfig(name=optimizer, **OPT)
    pipe = TokenPipeline(cfg.vocab_size, 4, 16)
    runs = {}
    for donate in (False, True):
        setup = make_train_step(model, opt_cfg=opt, device=CPU,
                                donate=donate)
        state = setup.init_state(0)
        first = _leaves(state.params)
        for step in range(3):
            tokens, labels = pipe.batch_at(step)
            state, metrics = setup.step_fn(state, {
                "tokens": torch.from_numpy(tokens),
                "labels": torch.from_numpy(labels)})
        same = all(a is b for a, b in zip(first, _leaves(state.params)))
        assert same == donate
        runs[donate] = (state, float(metrics["loss"]))
    (ref_state, ref_loss), (state, loss) = runs[False], runs[True]
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    for tree, ref_tree in ((state.params, ref_state.params),
                           (state.opt_state, ref_state.opt_state)):
        for a, b in zip(_leaves(tree), _leaves(ref_tree)):
            assert a.shape == b.shape
            if b.numel():
                _close(a, b.numpy(), 1e-6)


# --------------------------------------------------------------------------
# launch/serve.py
# --------------------------------------------------------------------------
def test_serve_lm_mode_on_the_cpu():
    """--arch rwkv6_1b6 --smoke end to end: prefill + greedy decode, the
    same tokens on a second run (seeded), and the timings printed."""
    args = ["--arch", "rwkv6_1b6", "--smoke", "--batch", "2",
            "--prompt-len", "8", "--gen", "3", "--device", CPU]
    res = serve_mod.main(args)
    assert res.tokens.shape == (2, 3)
    assert np.issubdtype(res.tokens.dtype, np.integer)
    assert res.prefill_ms > 0 and res.decode_ms_per_token > 0
    assert res.tokens_per_s > 0
    np.testing.assert_array_equal(serve_mod.main(args).tokens, res.tokens)
    # the chunk-parallel prefill: a prompt longer than the chunk
    chunked = serve_mod.main(["--arch", "rwkv6_1b6", "--smoke", "--batch",
                              "2", "--prompt-len", "32", "--gen", "2",
                              "--device", CPU])
    assert chunked.tokens.shape == (2, 2)


def test_serve_curves_mode_on_the_cpu():
    m = serve_mod.main(["--service", "curves", "--tenants", "2", "--rounds",
                        "2", "--n", "6", "--m", "8", "--lbfgs-iters", "5",
                        "--device", CPU])
    assert m["counters"]["cold_fits"] == 2
    assert m["counters"]["observes"] == 2 + 2 * 2
    assert m["counters"]["predicts"] == 2 * 2 + 2


def test_serve_lm_mode_needs_an_arch():
    with pytest.raises(SystemExit):
        serve_mod.main(["--device", CPU])
