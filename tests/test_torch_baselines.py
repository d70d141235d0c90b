"""PyTorch port, the layers, the curve-transformer baseline, its pre-training
batches and the head-to-head harness (``repro_torch.models``,
``repro_torch.baselines``), held against the reference on the same numpy
inputs and carried parameters.

Float32 forward outputs are held to 1e-5 relative to the largest reference
value, gradients to 1e-4 of the largest reference gradient entry; the
host-numpy pieces (batches, masks, scores) are equal. The LKGP rows of the
head-to-head fit in float64 on the dense engine and read the Matheron
variance from the reference's own draws, so they agree to the rounding of
the rows (5 decimals).
"""
import jax

jax.config.update("jax_enable_x64", True)

import math  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.baselines as ref_bl  # noqa: E402
import repro.baselines.evaluate as ref_eval  # noqa: E402
import repro.core as ref_core  # noqa: E402
import repro.models.layers as ref_layers  # noqa: E402
from repro_torch import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.baselines import (CurveTransformerConfig,  # noqa: E402
                                   PretrainConfig, build_curve_model,
                                   curve_loss, cutoff_masks, eval_transformer,
                                   forward, gaussian_nll, head_to_head,
                                   normalize_t, param_table, predict_task,
                                   pretrain, sample_stream_batch,
                                   score_predictions)
from repro_torch.baselines import evaluate as port_eval  # noqa: E402
from repro_torch.baselines.curve_transformer import softplus  # noqa: E402
from repro_torch.baselines.pretrain import _prefix_floor  # noqa: E402
from repro.baselines.pretrain import _prefix_floor as ref_prefix_floor  # noqa
from repro_torch.core import LKGPConfig, Posterior  # noqa: E402
from repro_torch.data import sample_suite, sample_task  # noqa: E402
from repro_torch.models import (attention, build_params, mlp,  # noqa: E402
                                mlp_params, rms_norm, table_logical)
from test_torch_schedulers import _reference_normals  # noqa: E402

CPU = "cpu"
FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
TINY = dict(d_model=16, num_layers=1, num_heads=2, d_ff=32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol=FWD_RTOL, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=rtol * max(1e-30, float(np.abs(want).max())))


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x, s = _f32(rng, 3, 5, 16, scale=2.0), _f32(rng, 16, scale=0.3)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    assert got.dtype == torch.float32
    _close(got, ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))
    # the scale is applied as 1 + scale: a zero scale is the plain norm
    plain = rms_norm(torch.from_numpy(x), torch.zeros(16))
    _close(plain, x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-6))


@pytest.mark.parametrize("act,bias", [("swiglu", False), ("geglu", False),
                                      ("gelu", True), ("relu2", True),
                                      ("gelu", False)])
def test_mlp_matches_reference(act, bias):
    """Every act, the gelus the tanh form (jax.nn.gelu's default)."""
    rng = np.random.default_rng(1)
    table = mlp_params(act, 8, 12, bias=bias)
    assert table == ref_layers.mlp_params(act, 8, 12, bias=bias)
    p = {k: _f32(rng, *shape, scale=0.5) for k, (shape, _, _) in
         table.items()}
    x = _f32(rng, 2, 3, 8)
    got = mlp(torch.from_numpy(x), {k: torch.from_numpy(v)
                                    for k, v in p.items()}, act)
    _close(got, ref_layers.mlp(jnp.asarray(x), p, act), what=act)
    with pytest.raises(ValueError):
        mlp(torch.from_numpy(x), {k: torch.from_numpy(v)
                                  for k, v in p.items()}, "tanh")


@pytest.mark.parametrize("S,causal,window,Hq,Hkv", [
    (7, False, None, 4, 4), (9, True, None, 4, 2), (12, True, 4, 2, 1),
    (2048, False, None, 2, 2), (2048, True, None, 2, 1),
    (2048, True, 700, 2, 2)])
def test_attention_matches_reference(S, causal, window, Hq, Hkv):
    """Both paths by the reference's rule: S=2048 (> 1024, divisible by the
    512 / 1024 chunks) is the chunked online softmax, the rest the plain
    one; GQA, causal and windowed masks."""
    rng = np.random.default_rng(S + Hq)
    q, k, v = (_f32(rng, 1, S, h, 4) for h in (Hq, Hkv, Hkv))
    got = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal=causal, window=window)
    want = ref_layers.attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window)
    _close(got, want, what=f"S={S}")
    if S == 2048:   # the chunked path agrees with the plain one
        plain = port_layers_plain(q, k, v, causal, window)
        _close(got, plain.numpy(), what="chunked vs plain")


def port_layers_plain(q, k, v, causal, window):
    from repro_torch.models.layers import _plain_attention
    return _plain_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal, window, 0)


def test_build_params_rules_and_statistics():
    """The port's draws (not the reference's PRNG): zero norms and biases
    by name, N(0, fan ** -1) entries, 0.02 without a fan; the nesting and
    the logical axes as the reference's."""
    cfg = CurveTransformerConfig()
    table = param_table(cfg)
    assert table == ref_bl.param_table(ref_bl.CurveTransformerConfig())
    params = build_params(torch.Generator().manual_seed(1), table)
    ref_params = ref_bl.build_curve_model(
        ref_bl.CurveTransformerConfig()).init(jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(tree_to_numpy(params)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray,
                                                            ref_params))
    assert table_logical(table) == \
        ref_bl.build_curve_model(ref_bl.CurveTransformerConfig()).logical
    for name, (shape, _, fan) in table.items():
        node = params
        for part in name.split("/"):
            node = node[part]
        a = node.numpy()
        assert a.shape == shape and a.dtype == np.float32
        if name.endswith(("ln1", "ln2", "final_norm")) or "/b" in name:
            assert not a.any(), name
            continue
        std = 0.02 if fan is None else fan ** -0.5
        assert abs(a.std() / std - 1) < 5 / np.sqrt(a.size) + 0.02, name


# --------------------------------------------------------------------------
# the curve transformer
# --------------------------------------------------------------------------
def _carried(cfg_kw=TINY, seed=0):
    rcfg = ref_bl.CurveTransformerConfig(**cfg_kw)
    rp = ref_bl.build_curve_model(rcfg).init(jax.random.PRNGKey(seed))
    rp["head"]["b"] = jnp.asarray([0.1, 25.0], jnp.float32)   # softplus > 20
    return (CurveTransformerConfig(**cfg_kw), rcfg,
            tree_from_numpy(jax.tree_util.tree_map(np.asarray, rp),
                            device=CPU), rp)


def _arrays(n=5, m=8, d=7, seed=0):
    task = sample_task(seed, n=n, m=m, d=d)
    return task.X, task.Y, task.mask, normalize_t(task.t), task


def test_softplus_is_jax_softplus_everywhere():
    """log(1 + exp(x)) on both sides of 20, where F.softplus turns into the
    identity; within an ulp of jax.nn.softplus (exp / log1p differ by one
    between the libraries)."""
    x = np.array([-40.0, -3.0, 0.0, 0.7, 19.9, 20.1, 35.0], np.float32)
    np.testing.assert_allclose(softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=2.4e-7)
    np.testing.assert_allclose(softplus(torch.tensor([-30.0, 25.0],
                                                     dtype=torch.float64)),
                               [math.exp(-30.0), 25.0 + math.exp(-25.0)],
                               rtol=1e-12)


def test_normalize_t_equals_reference():
    for t in (np.arange(1.0, 13.0), np.geomspace(1.0, 81.0, 9), [3.0, 3.0]):
        np.testing.assert_array_equal(
            normalize_t(t), np.asarray(ref_bl.normalize_t(np.asarray(t))))


@pytest.mark.parametrize("m", [8, 52])
def test_forward_matches_reference(m):
    """Carried parameters (the head's sigma bias pushed into softplus's
    > 20 range): mu and sigma within FWD_RTOL."""
    cfg, rcfg, p, rp = _carried()
    X, Y, mask, tn, _ = _arrays(n=6, m=m)
    mu, sigma = forward(p, torch.from_numpy(X), torch.from_numpy(Y),
                        torch.from_numpy(mask), torch.from_numpy(tn), cfg)
    rmu, rsigma = ref_bl.forward(rp, jnp.asarray(X), jnp.asarray(Y),
                                 jnp.asarray(mask), jnp.asarray(tn), rcfg)
    assert mu.dtype == torch.float32 and mu.shape == (6, m)
    _close(mu, rmu, what="mu")
    _close(sigma, rsigma, what="sigma")


def test_loss_and_gradient_match_reference():
    cfg, rcfg, p, rp = _carried(dict(TINY, num_layers=2), seed=3)
    p["head"]["b"] = torch.tensor([0.1, -0.5])
    rp["head"]["b"] = jnp.asarray([0.1, -0.5], jnp.float32)
    batch = sample_stream_batch(PretrainConfig(tasks_per_step=2, n=5, m=8),
                                3)
    rl, rg = jax.jit(jax.value_and_grad(ref_bl.curve_loss),
                     static_argnums=2)(
        rp, {k: jnp.asarray(v) for k, v in batch.items()}, rcfg)
    flat = _flat(p)
    live = {k: v.clone().requires_grad_() for k, v in flat.items()}
    loss = curve_loss(_nest(live), {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, cfg)
    grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(rl), rtol=FWD_RTOL)
    rflat = {k: np.asarray(v) for k, v in _flat(rg).items()}
    scale = max(np.abs(v).max() for v in rflat.values())
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), rflat[name], rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for q in parents:
            node = node.setdefault(q, {})
        node[leaf] = v
    return out


def test_predictions_ignore_masked_out_values():
    cfg, _, p, _ = _carried()
    X, Y, mask, tn, _ = _arrays(seed=1)
    args = [torch.from_numpy(a) for a in (X, Y, mask, tn)]
    mu1, sig1 = forward(p, args[0], args[1], args[2], args[3], cfg)
    garbage = torch.where(args[2] > 0, args[1],
                          torch.full_like(args[1], 1e6))
    mu2, sig2 = forward(p, args[0], garbage, args[2], args[3], cfg)
    assert torch.equal(mu1, mu2) and torch.equal(sig1, sig2)


def test_gaussian_nll_is_correct():
    got = float(gaussian_nll(torch.tensor(0.3), torch.tensor(0.5),
                             torch.tensor(0.8)))
    ref = 0.5 * math.log(2 * math.pi * 0.25) + 0.5 * 0.5 ** 2 / 0.25
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_predict_task_matches_reference():
    cfg, rcfg, p, rp = _carried()
    task = sample_task(4, n=6, m=9, d=7)
    mean, var = predict_task(p, cfg, task.X, task.t, task.Y, task.mask)
    rmean, rvar = ref_bl.predict_task(rp, rcfg, task.X, task.t, task.Y,
                                      task.mask)
    assert mean.dtype == np.float64 and var.shape == (6, 9)
    _close(mean, rmean)
    _close(var, rvar, rtol=2 * FWD_RTOL)


# --------------------------------------------------------------------------
# pre-training
# --------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 1, 57, 99])
def test_stream_batch_equals_reference(step):
    cfg = PretrainConfig(steps=100, tasks_per_step=2, n=6, m=8, seed=3)
    rcfg = ref_bl.PretrainConfig(steps=100, tasks_per_step=2, n=6, m=8,
                                 seed=3)
    ours, ref = sample_stream_batch(cfg, step), \
        ref_bl.sample_stream_batch(rcfg, step)
    assert ours.keys() == ref.keys()
    for k in ours:
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    assert _prefix_floor(cfg, step) == \
        ref_prefix_floor(rcfg, step)


def test_stream_batch_on_a_dataset_grid_equals_reference():
    t = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)
    ours = sample_stream_batch(PretrainConfig(tasks_per_step=2, n=4, m=6,
                                              t=t), 5)
    ref = ref_bl.sample_stream_batch(ref_bl.PretrainConfig(
        tasks_per_step=2, n=4, m=6, t=t), 5)
    for k in ours:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)


def test_stream_batch_curriculum_anneals_prefix_floor():
    cfg = PretrainConfig(steps=100, tasks_per_step=2, n=6, m=8)
    early, late = sample_stream_batch(cfg, 0), sample_stream_batch(cfg, 99)
    assert early["y"].shape == (12, 8) and early["hp"].shape == (12, 7)
    assert early["mask"].mean() > late["mask"].mean()


def test_pretrain_reduces_nll():
    cfg = PretrainConfig(steps=40, tasks_per_step=2, n=6, m=8, log_every=20)
    logs = []
    params, info = pretrain(CurveTransformerConfig(**TINY), cfg, device=CPU,
                            out=logs.append)
    assert info["final_loss"] < info["first_loss"], info
    assert info["steps"] == 40 and len(logs) == 2
    assert all(torch.isfinite(v).all() for v in _flat(params).values())


# --------------------------------------------------------------------------
# evaluation
# --------------------------------------------------------------------------
def test_cutoff_masks_equal_reference_and_anchored():
    task = sample_task(5, n=8, m=10)
    masks = cutoff_masks(task, (0.2, 0.5), seed=3)
    ref = ref_bl.cutoff_masks(task, (0.2, 0.5), seed=3)
    for f in (0.2, 0.5):
        np.testing.assert_array_equal(masks[f], ref[f])
        lens = masks[f].sum(axis=1)
        assert lens.max() == 10
        assert (lens == max(1, round(f * 10))).sum() >= 7


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spearman_and_ranks_equal_reference(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, 12).astype(float)     # ties
    b = rng.standard_normal(12)
    np.testing.assert_array_equal(port_eval._rank_with_ties(a),
                                  ref_eval._rank_with_ties(a))
    assert port_eval._spearman(a, b) == ref_eval._spearman(a, b)
    assert math.isnan(port_eval._spearman(np.ones(4), b[:4]))


def test_score_predictions_equal_reference():
    """Random predictions, with and without a validity mask; and the
    oracle: ~zero MAE, perfect rank."""
    task = sample_task(7, n=10, m=9)
    mask = cutoff_masks(task, (0.3,), seed=0)[0.3]
    rng = np.random.default_rng(0)
    mean = task.Y_full + 0.05 * rng.standard_normal(task.Y_full.shape)
    var = rng.uniform(1e-4, 1e-2, task.Y_full.shape)
    valid = (rng.uniform(size=mask.shape) < 0.8).astype(float)
    for v in (None, valid):
        ours = score_predictions(mean, var, task, mask, valid=v)
        ref = ref_bl.score_predictions(mean, var, task, mask, valid=v)
        assert ours.keys() == ref.keys()
        for k in ours:
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-12)
    s = score_predictions(task.Y_full, np.full_like(task.Y_full, 1e-4), task,
                          mask)
    assert s["mae"] < 1e-12 and s["rank_corr"] > 0.999


@pytest.fixture
def reference_variance_draws(monkeypatch):
    """The port's default Matheron samples on the reference's draws for the
    same stream (``fold_in(PRNGKey(seed), 1)``)."""
    def default_samples(self):
        st = self._state
        key = jax.random.fold_in(jax.random.PRNGKey(st.config.seed), 1)
        normals = _reference_normals(key, st.config.posterior_samples, st.n,
                                     st.m)
        return self.samples(None, normals=normals)

    monkeypatch.setattr(Posterior, "_default_samples",
                        property(default_samples))


def test_head_to_head_rows_match_reference(reference_variance_draws):
    """The rows' structure as the reference's test asks, and every LKGP row
    equal to the reference's (dense float64 fit, the reference's draws for
    the variance) to the rows' rounding; the transformer's rows from
    carried parameters within FWD_RTOL."""
    cfg, rcfg, p, rp = _carried()
    tasks = sample_suite(31, 2, n=6, m=8, d=7)
    gp = dict(lbfgs_iters=4, posterior_samples=32)
    rows = head_to_head(p, cfg, tasks, cutoffs=(0.25, 0.5),
                        gp_cfg=LKGPConfig(**gp), seed=0, device=CPU)
    ref = ref_bl.head_to_head(rp, rcfg, tasks, cutoffs=(0.25, 0.5),
                              gp_cfg=ref_core.LKGPConfig(**gp), seed=0)
    assert len(rows) == len(ref) == 2 * 2 * 2
    assert {r["model"] for r in rows} == {"lkgp", "transformer"}
    for r, rr in zip(rows, ref):
        for k in ("suite", "task", "cutoff", "model"):
            assert r[k] == rr[k]
        for k in ("nll", "mae", "rank_corr", "fit_s", "predict_s"):
            assert np.isfinite(r[k]), r
        tol = 2e-5 if r["model"] == "lkgp" else 1e-4 * max(1, abs(rr["nll"]))
        for k in ("nll", "mae", "rank_corr"):
            np.testing.assert_allclose(r[k], rr[k], rtol=0, atol=tol,
                                       err_msg=f"{r['model']} {k}")
    assert all(r["fit_s"] == 0.0 for r in rows if r["model"] == "transformer")


def test_head_to_head_valid_masks_skip_unscorable_cells():
    cfg, _, p, _ = _carried()
    task = sample_task(3, n=5, m=6, d=7)
    valid = np.ones_like(task.mask)
    valid[:, 2:] = 0.0            # no ground truth past epoch 2
    rows = head_to_head(p, cfg, [task], cutoffs=(0.2, 0.7),
                        gp_cfg=LKGPConfig(lbfgs_iters=2), seed=0,
                        valid_masks=[valid], device=CPU)
    # at 0.7 every valid cell is observed: only the 0.2 cutoff is scored
    assert {r["cutoff"] for r in rows} == {0.2} and len(rows) == 2


def test_eval_transformer_uses_only_masked_inputs():
    cfg, _, p, _ = _carried()
    task = sample_task(41, n=6, m=8)
    mask = cutoff_masks(task, (0.4,), seed=1)[0.4]
    p1 = eval_transformer(p, cfg, task, mask)
    leaked = task._replace(Y_full=np.where(mask > 0, task.Y_full, -7.0))
    p2 = eval_transformer(p, cfg, leaked, mask)
    np.testing.assert_array_equal(p1["mean"], p2["mean"])


def test_model_endpoints():
    cfg = CurveTransformerConfig(**TINY)
    model = build_curve_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    X, Y, mask, tn, task = _arrays()
    batch = {"hp": torch.from_numpy(X), "y": torch.from_numpy(Y),
             "mask": torch.from_numpy(mask), "t_norm": torch.from_numpy(tn),
             "target": torch.from_numpy(task.Y_full)}
    assert torch.isfinite(model.loss(params, batch))
    mu, sigma = model.predict(params, batch["hp"], batch["y"], batch["mask"],
                              batch["t_norm"])
    assert mu.shape == Y.shape and bool((sigma > cfg.min_sigma * 0.99).all())
