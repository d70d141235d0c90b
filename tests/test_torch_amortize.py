"""PyTorch port, the amortized hyper-parameter init (``repro_torch.amortize``)
and its wiring into ``fit`` / ``fit_batch`` / ``refit`` and the schedulers,
each held against ``repro.amortize`` on the same numpy inputs.

The two packages' PRNGs differ, so an amortizer's parameters are drawn once
by the reference and carried across (``convert.tree_from_numpy``); the
port's own ``init_amortizer`` is held by its statistics. The encoder runs in
float32 in both packages, whose summation orders differ: its outputs are
held to 1e-5 relative, the float64 fits started from them to 1e-6, the
training loss to 1e-5 and its gradient to 1e-4. The identities the port
keeps on its own are bitwise: the untrained amortizer is the default init,
``init_batch`` is ``init_for``, ``fit_batch`` polish is per-task ``fit``.
"""
import jax

jax.config.update("jax_enable_x64", True)

import hashlib  # noqa: E402
from pathlib import Path  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.amortize as ref_am  # noqa: E402
import repro.autotune as ref_autotune  # noqa: E402
import repro.core as ref_core  # noqa: E402
import repro.data as ref_data  # noqa: E402
from repro.core.state import _flatten_params as ref_flatten  # noqa: E402
import repro_torch.autotune as port_autotune  # noqa: E402
from repro_torch import data, tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.amortize import (FIXTURE_DIR, AmortizeTrainConfig,  # noqa
                                  Amortizer, AmortizerConfig,
                                  build_amortizer_model,
                                  clear_amortizer_registry, get_amortizer,
                                  init_amortizer, param_table,
                                  register_amortizer, sample_amortize_batch,
                                  train_amortizer)
from repro_torch.core import (LKGPConfig, fit, fit_batch, init_params,  # noqa
                              refit, extend, unstack)
from repro_torch.core import state as state_mod  # noqa: E402
from repro_torch.core.state import (_POLISH_BACKTRACKS,  # noqa: E402
                                    _POLISH_CACHE, _flatten_params,
                                    compiled_cache_stats)
from test_torch_schedulers import (_gp, _race, _same_summary,  # noqa: E402
                                   handed_draws)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
INIT_RTOL = 1e-5     # float32 encoder outputs, relative to max|reference|
FIT_TOL = 1e-6       # float64 polished parameters started from them,
#                      relative to max(1, |reference|)
TINY = dict(d_model=16, curve_layers=1, set_layers=1, num_heads=2, d_ff=32,
            fourier_feats=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes are tiny and the suite's workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_registries():
    clear_amortizer_registry()
    ref_am.clear_amortizer_registry()
    yield
    clear_amortizer_registry()
    ref_am.clear_amortizer_registry()


def _pair(d=3, seed=0, trained=True):
    """One tiny amortizer in both packages, the reference's parameters
    carried across; ``trained`` gives the zeroed last head weight values,
    so the init is not the default one."""
    rcfg = ref_am.AmortizerConfig(d=d, **TINY)
    p = ref_am.init_amortizer(jax.random.PRNGKey(seed), rcfg)
    if trained:
        p["head"]["w1"] = 0.3 * jax.random.normal(
            jax.random.PRNGKey(seed + 100), p["head"]["w1"].shape,
            jnp.float32)
    ours = Amortizer(AmortizerConfig(d=d, **TINY),
                     tree_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                     device=CPU))
    return ours, ref_am.Amortizer(rcfg, p)


def _tasks(seed, B=3, n=6, m=5, d=3):
    """B same-shape prefix-revealed tasks (the reference's test helper)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(B, n, d))
    t = np.linspace(0.05, 1.0, m)
    Y = rng.normal(size=(B, n, m))
    lens = rng.integers(2, m + 1, size=(B, n))
    mask = (np.arange(m)[None, None, :] < lens[:, :, None]).astype(float)
    return X, t, Y * mask, mask


def _transformed(n, m, d, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(n, m)) < 0.6).astype(np.float64)
    mask[:, 0] = 1.0
    return (rng.uniform(size=(n, d)), np.linspace(0.0, 1.0, m),
            rng.normal(size=(n, m)) * mask, mask)


# --------------------------------------------------------------------------
# the encoder
# --------------------------------------------------------------------------
def test_fixture_is_a_byte_copy_of_the_reference():
    ours = (FIXTURE_DIR / "amortizer_d5.npz").read_bytes()
    ref = (ROOT / "src/repro/amortize/fixtures/amortizer_d5.npz").read_bytes()
    assert hashlib.sha256(ours).hexdigest() == hashlib.sha256(ref).hexdigest()
    assert FIXTURE_DIR.parent.name == "amortize" \
        and FIXTURE_DIR.parents[1].name == "repro_torch"


def test_untrained_amortizer_predicts_default_init():
    """Zero last head weight: the forward IS the prior-mean init, bit for
    bit (the port's init_params and the reference's)."""
    am, _ = _pair(trained=False)
    X, t, Y, mask = _tasks(0, B=1)
    flat = am.init_flat(X[0], t, Y[0], mask[0])
    base = _flatten_params(init_params(3, torch.float32, CPU))
    assert flat.dtype == torch.float32 and torch.equal(flat, base)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(ref_flatten(ref_core.init_params(
            3, jnp.float32))))
    gen = torch.Generator().manual_seed(0)
    own = Amortizer(AmortizerConfig(d=3, **TINY),
                    init_amortizer(gen, AmortizerConfig(d=3, **TINY)))
    assert torch.equal(own.init_flat(X[0], t, Y[0], mask[0]), base)


@pytest.mark.parametrize("n,m", [(12, 9), (40, 7), (2048, 6)])
def test_fixture_init_flat_matches_reference(n, m):
    """The committed d=5 fixture on the same transformed task, within
    INIT_RTOL; n=2048 sends the set stage through the chunked attention."""
    ours = Amortizer.load(FIXTURE_DIR / "amortizer_d5.npz", device=CPU)
    ref = ref_am.get_amortizer(5)
    args = _transformed(n, m, 5, seed=n)
    got = ours.init_flat(*args).numpy()
    want = np.asarray(ref.init_flat(*args))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=INIT_RTOL * np.abs(want).max())


def test_init_amortizer_statistics():
    """The port's own draws (its PRNG is not the reference's): zero norms,
    biases and last head weight; every other entry ~ N(0, fan ** -1)."""
    cfg = AmortizerConfig(d=7, d_model=64, d_ff=128)
    params = init_amortizer(torch.Generator().manual_seed(3), cfg)
    flat = {k: v.numpy() for k, v in _flat(params).items()}
    table = param_table(cfg)
    assert set(flat) == set(table)
    for name, (shape, _, fan) in table.items():
        a = flat[name]
        assert a.shape == shape and a.dtype == np.float32, name
        zero = (name.endswith(("ln1", "ln2", "final_norm")) or "/b" in name
                or name == "head/w1")
        if zero:
            assert not a.any(), name
            continue
        std = 0.02 if fan is None else fan ** -0.5
        assert abs(a.mean()) < 4 * std / np.sqrt(a.size), name
        assert abs(a.std() / std - 1) < 5 / np.sqrt(a.size) + 0.02, name


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_save_load_roundtrip_bitwise(tmp_path):
    am, _ = _pair(seed=3)
    path = tmp_path / "am.npz"
    am.save(path)
    am2 = Amortizer.load(path, device=CPU)
    assert am2.cfg == am.cfg
    a, b = _flat(am.params), _flat(am2.params)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    X, t, Y, mask = _tasks(1, B=1)
    assert torch.equal(am.init_flat(X[0], t, Y[0], mask[0]),
                       am2.init_flat(X[0], t, Y[0], mask[0]))


def test_files_cross_load_between_packages(tmp_path):
    """A file the port writes loads in the reference and vice versa: the
    same config, the same parameter bits, the same predictions."""
    ours, ref = _pair(seed=4)
    ours.save(tmp_path / "port.npz")
    ref.save(tmp_path / "ref.npz")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") \
            as b:
        assert sorted(a.files) == sorted(b.files)
        assert str(a["__cfg__"]) == str(b["__cfg__"])
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    in_ref = ref_am.Amortizer.load(tmp_path / "port.npz")
    in_port = Amortizer.load(tmp_path / "ref.npz", device=CPU)
    assert in_port.cfg == ours.cfg
    X, t, Y, mask = _tasks(2, B=1)
    args = (X[0], t, Y[0], mask[0])
    assert torch.equal(in_port.init_flat(*args), ours.init_flat(*args))
    np.testing.assert_array_equal(np.asarray(in_ref.init_flat(*args)),
                                  np.asarray(ref.init_flat(*args)))
    back = tree_to_numpy(in_port.params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, ref.params))


def test_init_batch_matches_init_for_bitwise():
    am, _ = _pair(seed=5)
    X, t, Y, mask = (torch.from_numpy(a) for a in _tasks(2, B=4))
    tb = t.expand(4, t.shape[0])
    batch = am.init_batch(X, tb, Y, mask)
    for i in range(4):
        single = am.init_for(X[i], t, Y[i], mask[i])
        for a, b in zip(single, batch):
            assert torch.equal(a, b[i])


def test_registry_and_fixture():
    am, _ = _pair()
    register_amortizer(am)
    assert get_amortizer(3) is am
    with pytest.raises(ValueError, match="amortizer"):
        get_amortizer(99, CPU)   # no registration, no fixture for d=99
    clear_amortizer_registry()
    fixture = get_amortizer(5, CPU)   # the committed d=5 fixture, lazily
    assert fixture.cfg.d == 5 and fixture.device == torch.device("cpu")
    assert get_amortizer(5) is fixture


# --------------------------------------------------------------------------
# fit / fit_batch / refit
# --------------------------------------------------------------------------
def _close_params(ours, ref):
    for name, want in ref._asdict().items():
        want = np.asarray(want)
        np.testing.assert_allclose(
            getattr(ours, name).numpy(), want, rtol=0,
            atol=FIT_TOL * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.mark.parametrize("polish_steps", [0, 2])
def test_fit_amortized_polish_matches_reference(polish_steps):
    """fit(init="amortized", polish_steps=k) from the same (carried)
    amortizer: parameters within FIT_TOL of the reference's, the same
    provenance and evaluation count."""
    ours, ref = _pair(seed=7)
    X, t, Y, mask = _tasks(3, B=1, n=8, m=6)
    st = fit(X[0], t, Y[0], mask[0], LKGPConfig(), init="amortized",
             polish_steps=polish_steps, amortizer=ours, device=CPU)
    rst = ref_core.fit(X[0], t, Y[0], mask[0], ref_core.LKGPConfig(),
                       init="amortized", polish_steps=polish_steps,
                       amortizer=ref)
    assert st.params.raw_noise.dtype == torch.float64
    _close_params(st.params, rst.params)
    res, rres = st.fit_result, rst.fit_result
    assert (res.init_source, res.optimizer, res.n_evals) == \
        (rres.init_source, rres.optimizer, rres.n_evals)
    np.testing.assert_allclose(res.fun, rres.fun, rtol=FIT_TOL)


def test_fit_matches_fit_batch_polish_bitwise():
    """Same task + same amortized init + same budget: identical parameters
    whether fit alone or through the coalesced batch path."""
    am, _ = _pair(seed=7)
    X, t, Y, mask = _tasks(3, B=3)
    cfg = LKGPConfig()
    stb = fit_batch(X, t, Y, mask, cfg, init="amortized", polish_steps=2,
                    amortizer=am, device=CPU)
    singles = [fit(X[i], t, Y[i], mask[i], cfg, init="amortized",
                   polish_steps=2, amortizer=am, device=CPU)
               for i in range(3)]
    for i, (sb, ss) in enumerate(zip(unstack(stb), singles)):
        for a, b in zip(ss.params, sb.params):
            assert torch.equal(a, b), f"task {i}"
    res = stb.fit_result
    assert res.optimizer == "polish" and res.init_source == "amortized"
    assert res.budget == 2 and res.n_iters == 2
    assert res.n_evals == 3 * (1 + 2 * _POLISH_BACKTRACKS)


def test_polish_program_shared_between_fit_and_fit_batch():
    am, _ = _pair(seed=9)
    X, t, Y, mask = _tasks(4, B=2)
    cfg = LKGPConfig(jitter=1.1e-6)   # a cache key of this test's own
    _POLISH_CACHE.clear()
    fit(X[0], t, Y[0], mask[0], cfg, init="amortized", polish_steps=2,
        amortizer=am, device=CPU)
    fit_batch(X, t, Y, mask, cfg, init="amortized", polish_steps=2,
              amortizer=am, device=CPU)
    assert len(_POLISH_CACHE) == 1
    stats = compiled_cache_stats()["polish"]
    assert stats["misses"] >= 1 and stats["hits"] >= 2


def test_oneshot_fit_is_the_amortized_init_bitwise():
    am, _ = _pair(seed=11)
    X, t, Y, mask = _tasks(5, B=1)
    st = fit(X[0], t, Y[0], mask[0], LKGPConfig(), init="amortized",
             polish_steps=0, amortizer=am, device=CPU)
    assert st.fit_result.optimizer == "none"
    assert st.fit_result.init_source == "amortized"
    want = am.init_flat(st.x_tf(st.X), st.t_tf(st.t), st.y_tf(st.Y),
                        st.mask).double()
    assert torch.equal(_flatten_params(st.params), want)
    stp = fit(X[0], t, Y[0], mask[0], LKGPConfig(), init="amortized",
              polish_steps=3, amortizer=am, device=CPU)
    assert stp.fit_result.fun <= st.fit_result.fun + 1e-12


def test_hyper_init_config_drives_registry_and_refit_reamortizes():
    """cfg.hyper_init="amortized" pulls the registered encoder; a refit
    re-amortizes on the extended data (not a warm start), as the
    reference's does: the parameters within FIT_TOL of its."""
    ours, ref = _pair(seed=13)
    register_amortizer(ours)
    ref_am.register_amortizer(ref)
    X, t, Y, mask = _tasks(7, B=1, n=7, m=6)
    grown = mask[0].copy()
    grown[:, :4] = 1.0
    cfg = dict(hyper_init="amortized", polish_steps=2)
    st = fit(X[0], t, Y[0], mask[0], LKGPConfig(**cfg), device=CPU)
    rst = ref_core.fit(X[0], t, Y[0], mask[0], ref_core.LKGPConfig(**cfg))
    assert st.fit_result.init_source == "amortized"
    Y2 = np.where(grown > 0, np.random.default_rng(1).normal(size=grown.shape),
                  0.0)
    Y2 = np.where(mask[0] > 0, Y[0], Y2)
    st2 = refit(extend(st, Y2, grown))
    rst2 = ref_core.refit(ref_core.extend(rst, Y2, grown))
    assert st2.fit_result.init_source == "amortized"
    warm = refit(extend(st, Y2, grown), init=st.params)
    assert warm.fit_result.init_source == "params"
    _close_params(st2.params, rst2.params)
    d = st2.d
    start = ours.init_flat(st2.x_tf(st2.X), st2.t_tf(st2.t), st2.y_tf(st2.Y),
                           st2.mask)
    again = fit(st2.X, st2.t, st2.Y, st2.mask, LKGPConfig(**cfg),
                init=state_mod._unflatten_params(start.double(), d),
                device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(again.params, st2.params))


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 7])
def test_sample_amortize_batch_equals_reference(step):
    acfg = AmortizerConfig(d=4)
    tcfg = AmortizeTrainConfig(tasks_per_step=3, n=5, m=6, seed=2)
    ours = sample_amortize_batch(acfg, tcfg, step)
    ref = ref_am.sample_amortize_batch(ref_am.AmortizerConfig(d=4),
                                       ref_am.AmortizeTrainConfig(
                                           tasks_per_step=3, n=5, m=6,
                                           seed=2), step)
    assert ours.keys() == ref.keys()
    for k in ours:
        assert ours[k].dtype == np.float32 and ours[k].shape == ref[k].shape
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)


def test_amortizer_loss_and_gradient_match_reference():
    """The self-supervised objective on one batch with carried parameters:
    the loss within 1e-5 relative, every gradient leaf within 1e-4 of the
    largest reference gradient entry."""
    ours, ref = _pair(d=4, seed=17)
    batch = sample_amortize_batch(AmortizerConfig(d=4),
                                  AmortizeTrainConfig(tasks_per_step=3, n=5,
                                                      m=6), 0)
    model = build_amortizer_model(ours.cfg)
    rmodel = ref_am.build_amortizer_model(ref.cfg)
    rl, rg = jax.jit(jax.value_and_grad(rmodel.loss))(
        ref.params, {k: jnp.asarray(v) for k, v in batch.items()})
    live = {k: v.clone().requires_grad_() for k, v in _flat(ours.params)
            .items()}
    from repro_torch.amortize.encoder import _nest_tree
    loss = model.loss(_nest_tree(live), {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(live.values()))
    np.testing.assert_allclose(float(loss.detach()), float(rl), rtol=1e-5)
    rflat = {k: np.asarray(v) for k, v in _flat(rg).items()}
    scale = max(np.abs(v).max() for v in rflat.values())
    for (name, _), g in zip(live.items(), grads):
        np.testing.assert_allclose(g.numpy(), rflat[name], rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_train_amortizer_smoke():
    """Two tiny self-supervised steps run and keep the loss finite."""
    acfg = AmortizerConfig(d=4, **TINY)
    tcfg = AmortizeTrainConfig(steps=2, tasks_per_step=2, n=4, m=5,
                               log_every=1)
    logs = []
    am, info = train_amortizer(acfg, tcfg, device=CPU, out=logs.append)
    assert isinstance(am, Amortizer) and len(logs) == 2
    assert np.isfinite(info["first_loss"]) and np.isfinite(info["final_loss"])
    X, t, Y, mask = _tasks(9, B=1, n=4, m=5, d=4)
    assert torch.isfinite(am.init_flat(X[0], t, Y[0], mask[0])).all()


# --------------------------------------------------------------------------
# the schedulers
# --------------------------------------------------------------------------
def test_curve_predictor_with_amortizer_makes_the_reference_decisions(
        handed_draws):
    """Successive halving with LKGP promotion whose every fit and refit is
    amortized + 2 polish steps (``SHConfig(amortizer=...)``), the carried
    amortizer in both packages and the reference's draws handed across:
    every rung, ``selected`` and the budget equal to the reference's."""
    ours_am, ref_am_ = _pair(d=5, seed=21)
    task = data.sample_task(seed=501, n=12, m=9, d=5, noise=0.005,
                            spike_prob=0.0, diverge_prob=0.0, crossing=True)
    hist = [1, 4, 7]
    fresh = np.setdiff1d(np.arange(12), hist).tolist()
    cfg = dict(min_epochs=1, eta=3, ucb_beta=0.0, refit_lbfgs_iters=8)
    sched, ours = _race(port_autotune, data, {"device": CPU}, task, "lkgp",
                        hist, fresh, 1, amortizer=ours_am,
                        gp=_gp(state_mod, polish_steps=2,
                               posterior_samples=64), **cfg)
    _, ref = _race(ref_autotune, ref_data, {}, task, "lkgp", hist, fresh, 1,
                   amortizer=ref_am_,
                   gp=_gp(ref_core, polish_steps=2, posterior_samples=64),
                   **cfg)
    _same_summary(ours, ref)
    res = sched.predictor.state.fit_result
    assert res.init_source == "amortized" and res.optimizer == "polish"


# --------------------------------------------------------------------------
# tests/fixtures/reference_amortizer.npz (what chip_smoke.py holds the card to)
# --------------------------------------------------------------------------
REFERENCE_NPZ = ROOT / "tests" / "fixtures" / "reference_amortizer.npz"
GAP_TOL = 1e-5       # per-observation objective units


@pytest.fixture(scope="module")
def reference_npz():
    with np.load(REFERENCE_NPZ) as z:
        return dict(z)


def test_reference_npz_is_the_reference_output(reference_npz):
    """One entry of each kind regenerated through JAX equals the file."""
    z = reference_npz
    args = [z[f"am0_{k}"] for k in ("Xn", "tn", "Yn", "mask")]
    np.testing.assert_array_equal(
        np.asarray(ref_am.get_amortizer(5).init_flat(*args)), z["am0_out"])
    from fixtures.make_reference_amortizer import CT_CONFIG, mll_gaps
    import repro.baselines as ref_bl
    params = {k.split("/", 1)[1]: v for k, v in z.items()
              if k.startswith("ct_params/")}
    rp = jax.tree_util.tree_map(jnp.asarray, tree_to_numpy(
        tree_from_numpy(params, device=CPU)))
    mu, _ = ref_bl.forward(rp, *(jnp.asarray(z[f"ct0_{k}"]) for k in
                                 ("hp", "y", "mask", "t_norm")),
                           ref_bl.CurveTransformerConfig(**CT_CONFIG))
    np.testing.assert_array_equal(np.asarray(mu), z["ct0_mu"])
    got = mll_gaps(0)
    want = [z[f"gap_{k}"][0] for k in ("converged", "default", "amortized",
                                       "polished")]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_port_matches_reference_npz(reference_npz):
    """The port on the CPU: the d=5 fixture's init_flat (n=40 and the
    chunked n=2048) within INIT_RTOL, the curve transformer's forward within
    INIT_RTOL, and seed 0's MLL-gap row within GAP_TOL."""
    from repro_torch.baselines import CurveTransformerConfig, forward
    from fixtures.make_reference_amortizer import CT_CONFIG, GAP_SHAPE
    z = reference_npz
    am = Amortizer.load(FIXTURE_DIR / "amortizer_d5.npz", device=CPU)
    for i in (0, 1):
        got = am.init_flat(*(z[f"am{i}_{k}"] for k in ("Xn", "tn", "Yn",
                                                       "mask"))).numpy()
        want = z[f"am{i}_out"]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=INIT_RTOL * np.abs(want).max())
    params = tree_from_numpy({k.split("/", 1)[1]: v for k, v in z.items()
                              if k.startswith("ct_params/")}, device=CPU)
    for i in (0, 1):
        mu, sigma = forward(params, *(torch.from_numpy(z[f"ct{i}_{k}"])
                                      for k in ("hp", "y", "mask", "t_norm")),
                            CurveTransformerConfig(**CT_CONFIG))
        for got, key in ((mu, "mu"), (sigma, "sigma")):
            want = z[f"ct{i}_{key}"]
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=INIT_RTOL * np.abs(want).max())
    task = data.sample_task(seed=900, noise=0.005, crossing=True, **GAP_SHAPE)
    args = (task.X, task.t, task.Y, task.mask)
    register_amortizer(am)

    def fun(**cfg):
        return fit(*args, LKGPConfig(**cfg), device=CPU).fit_result.fun

    conv = fun(lbfgs_iters=60)
    got = [conv, fun(polish_steps=0) - conv,
           fun(hyper_init="amortized", polish_steps=0) - conv,
           fun(hyper_init="amortized", polish_steps=2) - conv]
    want = [z[f"gap_{k}"][0] for k in ("converged", "default", "amortized",
                                       "polished")]
    np.testing.assert_allclose(got, want, rtol=0, atol=GAP_TOL)
