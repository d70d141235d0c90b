"""PyTorch port, the optimizers and the one-device train step
(``repro_torch.train``), held against ``repro.train`` on the same numpy
parameters, gradients and batches.

Everything here is float32 in both packages, whose summation orders differ:
a single optimizer step is held to 1e-6 (relative to max(1, |reference|)),
five trainer steps, whose gradients come through autograd on the one side
and ``jax.grad`` on the other, to 1e-4.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.amortize as ref_am  # noqa: E402
import repro.baselines as ref_bl  # noqa: E402
import repro.train.optimizers as ref_opt  # noqa: E402
from repro.distributed.sharding import TP_RULES  # noqa: E402
from repro.launch.mesh import make_debug_mesh  # noqa: E402
from repro.train.trainer import TrainState as RefTrainState  # noqa: E402
from repro.train.trainer import make_train_step as ref_make_train_step  # noqa
from repro_torch import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.amortize import (AmortizeTrainConfig,  # noqa: E402
                                  AmortizerConfig, build_amortizer_model,
                                  sample_amortize_batch)
from repro_torch.baselines import (CurveTransformerConfig,  # noqa: E402
                                   PretrainConfig, build_curve_model,
                                   sample_stream_batch)
from repro_torch.train import (OptConfig, TrainState,  # noqa: E402
                               apply_update, clip_by_global_norm, cosine_lr,
                               global_norm, init_opt_state, make_train_step)

CPU = "cpu"
STEP_TOL = 1e-6      # one optimizer step
TRAIN_TOL = 1e-4     # five trainer steps
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=6, weight_decay=0.1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(ours, ref, tol, path=""):
    """Every leaf of the port's tree against the reference's pytree."""
    if isinstance(ref, dict):
        assert set(ours) == set(ref), path
        for k in ref:
            _close(ours[k], ref[k], tol, f"{path}/{k}")
        return
    want = np.asarray(ref)
    got = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    assert got.shape == want.shape, path
    np.testing.assert_allclose(got, want, rtol=0, err_msg=path,
                               atol=tol * max(1.0, float(np.abs(want).max()
                                                         if want.size else 0)))


def _tree(rng, shapes, scale=1.0, positive=False):
    out = {}
    for name, shape in shapes.items():
        a = rng.standard_normal(shape).astype(np.float32) * scale
        out[name] = np.abs(a) if positive else a
    return out


SHAPES = {"w": (6, 5), "b": (5,), "scale": (3,), "stack": (2, 4, 3)}
FACTORED = dict(SHAPES, big=(128, 130), deep=(2, 128, 128))


# --------------------------------------------------------------------------
# the schedule, the norm, the clip
# --------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 1, 2, 3, 5, 6, 9])
def test_cosine_lr_matches_reference(step):
    cfg, rcfg = OptConfig(**OPT), ref_opt.OptConfig(**OPT)
    got = cosine_lr(cfg, step)
    want = ref_opt.cosine_lr(rcfg, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7)


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(0)
    g = _tree(rng, SHAPES, scale=3.0)
    ours = tree_from_numpy(g, device=CPU)
    np.testing.assert_allclose(float(global_norm(ours)),
                               float(ref_opt.global_norm(g)), rtol=1e-6)
    for max_norm in (0.5, 1e3):
        clipped, norm = clip_by_global_norm(ours, max_norm)
        rclipped, rnorm = ref_opt.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, g), max_norm)
        np.testing.assert_allclose(float(norm), float(rnorm), rtol=1e-6)
        _close(clipped, rclipped, STEP_TOL)


def test_init_opt_state_shapes_match_reference():
    rng = np.random.default_rng(1)
    p = _tree(rng, FACTORED)
    for name in ("adamw", "adafactor"):
        ours = init_opt_state(tree_from_numpy(p, device=CPU),
                              OptConfig(name=name))
        ref = ref_opt.init_opt_state(jax.tree_util.tree_map(jnp.asarray, p),
                                     ref_opt.OptConfig(name=name))
        _close(ours, ref, 0.0)
    with pytest.raises(ValueError):
        init_opt_state({}, OptConfig(name="sgd"))


# --------------------------------------------------------------------------
# one step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name,step", [("adamw", 0), ("adamw", 3),
                                       ("adafactor", 0), ("adafactor", 4)])
def test_one_optimizer_step_matches_reference(name, step):
    """Random parameters, gradients and moments (the Adafactor tree has a
    factored 128 x 130 leaf and a stacked factored leaf beside unfactored
    ones): the new parameters, moments, lr and gradient norm within
    STEP_TOL. Weight decay reaches only leaves with ndim >= 2."""
    rng = np.random.default_rng(step)
    shapes = FACTORED if name == "adafactor" else SHAPES
    p, g = _tree(rng, shapes), _tree(rng, shapes, scale=0.7)
    cfg = OptConfig(name=name, **OPT)
    rcfg = ref_opt.OptConfig(name=name, **OPT)
    ref_state = ref_opt.init_opt_state(
        jax.tree_util.tree_map(jnp.asarray, p), rcfg)
    ref_state = jax.tree_util.tree_map(
        lambda z: jnp.asarray(np.abs(rng.standard_normal(z.shape))
                              .astype(np.float32) * 0.1), ref_state)
    ours_state = tree_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        ref_state),
                                 device=CPU)
    newp, news, metrics = apply_update(tree_from_numpy(p, device=CPU),
                                       tree_from_numpy(g, device=CPU),
                                       ours_state, step, cfg)
    rnewp, rnews, rmetrics = ref_opt.apply_update(
        jax.tree_util.tree_map(jnp.asarray, p),
        jax.tree_util.tree_map(jnp.asarray, g), ref_state,
        jnp.asarray(step, jnp.int32), rcfg)
    _close(newp, rnewp, STEP_TOL)
    _close(news, rnews, STEP_TOL)
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(rmetrics[k]),
                                   rtol=1e-6)
    if float(metrics["lr"]) > 0:
        # a 1-D leaf moves by the scaled update alone: no decay term
        assert not np.allclose(newp["b"].numpy(), p["b"])


def test_weight_decay_skips_one_dimensional_leaves():
    """With zero gradients AdamW moves a matrix by lr * wd * p and leaves a
    vector where it is."""
    p = {"w": np.ones((3, 3), np.float32), "b": np.ones(3, np.float32)}
    g = {k: np.zeros_like(v) for k, v in p.items()}
    cfg = OptConfig(**OPT)
    pt = tree_from_numpy(p, device=CPU)
    newp, _, metrics = apply_update(pt, tree_from_numpy(g, device=CPU),
                                    init_opt_state(pt, cfg), 3, cfg)
    lr = float(metrics["lr"])
    assert torch.equal(newp["b"], pt["b"])
    np.testing.assert_allclose(newp["w"].numpy(), 1.0 - lr * 0.1, rtol=1e-6)


# --------------------------------------------------------------------------
# five trainer steps
# --------------------------------------------------------------------------
def _curve_case():
    cfg = dict(d_in=7, d_model=16, num_layers=2, num_heads=2, d_ff=32)
    rmodel = ref_bl.build_curve_model(ref_bl.CurveTransformerConfig(**cfg))
    model = build_curve_model(CurveTransformerConfig(**cfg))
    params = rmodel.init(jax.random.PRNGKey(0))
    pre = PretrainConfig(tasks_per_step=2, n=6, m=8)
    batches = [sample_stream_batch(pre, s) for s in range(5)]
    return model, rmodel, params, batches


def _amortizer_case():
    kw = dict(d=4, d_model=16, curve_layers=1, set_layers=1, num_heads=2,
              d_ff=32, fourier_feats=2)
    rmodel = ref_am.build_amortizer_model(ref_am.AmortizerConfig(**kw))
    model = build_amortizer_model(AmortizerConfig(**kw))
    params = rmodel.init(jax.random.PRNGKey(1))
    # a trained-looking head, so every leaf has a gradient from step 0
    params["head"]["w1"] = 0.2 * jax.random.normal(
        jax.random.PRNGKey(2), params["head"]["w1"].shape, jnp.float32)
    tcfg = AmortizeTrainConfig(tasks_per_step=4, n=5, m=6)
    batches = [sample_amortize_batch(model.cfg, tcfg, s) for s in range(5)]
    return model, rmodel, params, batches


@pytest.mark.parametrize("case,grad_accum,opt", [
    ("curve", 1, "adamw"), ("amortizer", 1, "adamw"),
    ("amortizer", 2, "adamw"), ("curve", 1, "adafactor")])
def test_five_trainer_steps_match_reference(case, grad_accum, opt):
    """Five steps of make_train_step from the reference's initial parameters
    (carried across) on the same batches: every parameter, every moment
    and each step's loss within TRAIN_TOL. grad_accum=2 takes the
    reference's strided microbatches (rows i, i + 2, ...)."""
    model, rmodel, params, batches = (_curve_case if case == "curve"
                                      else _amortizer_case)()
    ocfg = OptConfig(name=opt, **OPT)
    rocfg = ref_opt.OptConfig(name=opt, **OPT)
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
    with mesh:
        for batch in batches:
            ours, m = setup.step_fn(ours, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
            ref, rm = rsetup.step_fn(ref, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
            np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                       rtol=TRAIN_TOL)
    assert int(ours.step) == int(ref.step) == 5
    _close(ours.params, ref.params, TRAIN_TOL)
    _close(ours.opt_state, ref.opt_state, TRAIN_TOL)
    assert tree_to_numpy(ours.params).keys() == ref.params.keys()


def test_train_step_reads_no_device_value_and_counts_steps():
    """The step's metrics are tensors (no host read inside the step), and
    init_state draws on the setup's device."""
    model, _, _, batches = _curve_case()
    setup = make_train_step(model, opt_cfg=OptConfig(**OPT), device=CPU)
    state = setup.init_state(0)
    again = setup.init_state(0)
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(state.params), _leaves(again.params)))
    state, metrics = setup.step_fn(state, {k: torch.from_numpy(v)
                                           for k, v in batches[0].items()})
    assert all(isinstance(v, torch.Tensor) for v in metrics.values())
    assert int(state.step) == 1 and setup.device == torch.device("cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]
