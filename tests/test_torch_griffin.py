"""PyTorch port, the LM zoo's Griffin hybrid (``repro_torch.models.griffin``,
``recurrentgemma_2b``), held against ``repro.models.griffin`` on the same
numpy inputs, with the reference's smoke parameters carried across by
``convert.tree_from_numpy``.

Everything here is float32 in both packages, whose summation orders differ
(the reference's ``associative_scan`` and the port's doubling scan pair the
steps differently). Tolerances: the gates, the conv and the decode
attention 1e-6 (relative to max(1, |reference|)); the RG-LRU's scan paths
1e-6 of max(1, |reference|), and on gates near 1 over 3072 steps 1e-5 of
max|h| against a float64 loop; the model's outputs, gradient and every cache
field 1e-5 of max|reference| (positions equal); the committed fixture 1e-5
of max|reference|; prefill + decode against a longer prefill the
reference's own band (rtol = atol = 2e-3).
"""
import importlib.util
import math
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.models as ref_models  # noqa: E402
import repro.models.griffin as ref_griffin  # noqa: E402
from repro_torch import tree_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import build_model, count_params  # noqa: E402
from repro_torch.models import griffin, layers, transformer  # noqa: E402

CPU = "cpu"
ARCH = "recurrentgemma_2b"
LAYER_TOL = 1e-6
SCAN_TOL = 1e-6
LONG_SCAN_TOL = 1e-5
MODEL_TOL = 1e-5
CONSISTENCY_TOL = 2e-3
FIXTURE = Path(__file__).resolve().parent / "fixtures" / \
    "reference_griffin.npz"
BATCH = 2
CACHE_FIELDS = ("h", "conv", "k", "v", "pos")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, what=""):
    """|got - want| <= tol * max(1, max|want|)."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _close_rel(got, want, tol, what=""):
    """|got - want| <= tol * max|want| (the model's outputs)."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _to_numpy(tree):
    return {k: _to_numpy(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


def _pair(key=0, seq=12, **overrides):
    """(port cfg, reference cfg, reference params, port params, numpy
    batch with labels)."""
    cfg = get_smoke_config(ARCH).replace(**overrides)
    rcfg = ref_configs.get_smoke_config(ARCH).replace(**overrides)
    rparams = ref_models.build_model(rcfg).init(jax.random.PRNGKey(key))
    params = tree_from_numpy(jax.tree_util.tree_map(np.asarray, rparams),
                             device=CPU)
    rng = np.random.default_rng(seq)
    data = {"tokens": rng.integers(0, cfg.vocab_size,
                                   (BATCH, seq)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size,
                                   (BATCH, seq)).astype(np.int32)}
    data["labels"][0, :3] = -1
    return cfg, rcfg, rparams, params, data


def _layer_pair(rparams, params, li=0):
    rlp = jax.tree_util.tree_map(lambda a: a[li], rparams["layers"])
    return rlp, transformer._layer(params["layers"], li)


def _assert_cache(cache, rcache, what=""):
    assert cache._fields == rcache._fields
    for field in CACHE_FIELDS:
        got, want = getattr(cache, field), getattr(rcache, field)
        if field == "pos":
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(_np(got), np.asarray(want),
                                          err_msg=f"{what} pos")
        elif np.abs(np.asarray(want)).max() == 0:
            assert not _np(got).any(), f"{what} {field}"
        else:
            _close_rel(got, want, MODEL_TOL, what=f"{what} {field}")
    assert cache.length.dtype == torch.int32 and cache.length.ndim == 0
    assert int(cache.length) == int(rcache.length)


# --------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_gates_match_reference(dtype):
    """a and the gated input, float32 from float32 or bf16 activations
    (the biases added in the activation dtype before the cast)."""
    cfg, _, rparams, params, _ = _pair()
    rlp, lp = _layer_pair(rparams, params)
    z = np.random.default_rng(0).standard_normal(
        (2, 7, cfg.rnn_width)).astype(np.float32)
    zt, zj = torch.from_numpy(z), jnp.asarray(z)
    p, rp = lp["rec"], rlp["rec"]
    if dtype == "bfloat16":
        zt, zj = zt.to(torch.bfloat16), zj.astype(jnp.bfloat16)
        p = {k: v.to(torch.bfloat16) for k, v in p.items()}
        rp = {k: v.astype(jnp.bfloat16) for k, v in rp.items()}
    a, b = griffin._rglru_gates(zt, p)
    ra, rb = ref_griffin._rglru_gates(zj, rp)
    assert a.dtype == b.dtype == torch.float32
    tol = LAYER_TOL if dtype == "float32" else 1e-2
    _close(a, np.asarray(ra, np.float32), tol)
    _close(b, np.asarray(rb, np.float32), tol)


@pytest.mark.parametrize("seq", [1, 2, 33])
def test_both_scan_paths_match_the_reference_scan(seq):
    """The doubling scan (the main path) and the sequential loop (the plain
    version) against the reference's associative_scan, at lengths that are
    not powers of two; the two paths against each other."""
    cfg, _, rparams, params, _ = _pair()
    rlp, lp = _layer_pair(rparams, params, 1)
    z = np.random.default_rng(seq).standard_normal(
        (2, seq, cfg.rnn_width)).astype(np.float32)
    want = ref_griffin._rglru_scan(jnp.asarray(z), rlp["rec"])
    got = griffin._rglru_scan(torch.from_numpy(z), lp["rec"])
    a, b = griffin._rglru_gates(torch.from_numpy(z), lp["rec"])
    loop = griffin._rglru_loop(a, b)
    _close(got, want, SCAN_TOL)
    _close(loop, want, SCAN_TOL)
    _close(got, loop.numpy(), SCAN_TOL)


def test_doubling_scan_takes_log_depth_and_survives_underflow(monkeypatch):
    """ceil(log2 S) steps, and decays whose products underflow to 0 give
    the loop's answer (the scan divides nothing)."""
    a = torch.full((1, 40, 3), 1e-30)
    b = torch.rand((1, 40, 3), generator=torch.Generator().manual_seed(0))
    h = griffin._doubling_scan(a, b)
    assert torch.isfinite(h).all()
    torch.testing.assert_close(h, griffin._rglru_loop(a, b), rtol=0,
                               atol=1e-6)
    calls = []
    real = torch.cat

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(torch, "cat", counting)
    griffin._doubling_scan(a, b)
    monkeypatch.undo()
    steps = math.ceil(math.log2(40))
    assert len(calls) == 2 * steps - 1      # b every step, a all but last


def _near_one_gates(S, R=64, seed=0):
    """Gates of a trained RG-LRU: a near 1, with 1 - a drawn per channel
    log-uniform in [1e-4, 1e-1] and jittered per step, so the slowest
    channels keep most of what they held 2048 steps back; b = sqrt(1 -
    a^2) x, as ``_rglru_gates`` builds it."""
    rng = np.random.default_rng(seed)
    rate = 10.0 ** rng.uniform(-4, -1, (1, 1, R))
    a = 1 - rate * rng.uniform(0.5, 1.5, (2, S, R))
    b = np.sqrt(1 - a * a) * rng.standard_normal((2, S, R))
    return (torch.from_numpy(a.astype(np.float32)),
            torch.from_numpy(b.astype(np.float32)))


@pytest.mark.parametrize("seq", [33, 3072])
def test_doubling_scan_holds_the_loop_on_gates_near_one(seq):
    """Every doubling offset up to 2048 matters here: the scan and the loop
    against the loop in float64 on the same float32 gates, within 1e-5 of
    max|h| (the scan's float32 products of up to 2048 decays round further
    than the loop's steps); at S = 3072, dropping what came 2048 steps
    back moves h by far more than that."""
    a, b = _near_one_gates(seq)
    want = griffin._rglru_loop(a.double(), b.double())
    tol = LONG_SCAN_TOL * float(want.abs().max())
    scan, loop = griffin._doubling_scan(a, b), griffin._rglru_loop(a, b)
    assert float((scan.double() - want).abs().max()) <= tol
    assert float((loop.double() - want).abs().max()) <= tol
    if seq > 2048:
        cut = griffin._rglru_loop(a[:, 2048:].double(), b[:, 2048:].double())
        assert float((cut - want[:, 2048:]).abs().max()) > 1e3 * tol


@pytest.mark.parametrize("case", ["no_tail", "tail", "short"])
def test_causal_conv_matches_reference(case):
    """Without a tail, with one, and at S < K - 1 (the new tail then holds
    the old tail's rows and zeros)."""
    cfg, _, rparams, params, _ = _pair()
    rlp, lp = _layer_pair(rparams, params)
    rng = np.random.default_rng(len(case))
    S = 2 if case == "short" else 9
    z = rng.standard_normal((2, S, cfg.rnn_width)).astype(np.float32)
    tail = None if case == "no_tail" else rng.standard_normal(
        (2, cfg.conv_width - 1, cfg.rnn_width)).astype(np.float32)
    if case == "short":
        tail[:, 0] = 0.0
    out, new_tail = griffin._causal_conv(
        torch.from_numpy(z), lp["rec"]["conv_w"], lp["rec"]["conv_b"],
        None if tail is None else torch.from_numpy(tail))
    rout, rtail = ref_griffin._causal_conv(
        jnp.asarray(z), rlp["rec"]["conv_w"], rlp["rec"]["conv_b"],
        None if tail is None else jnp.asarray(tail))
    _close(out, rout, LAYER_TOL)
    np.testing.assert_array_equal(_np(new_tail), np.asarray(rtail))
    assert new_tail.shape == (2, cfg.conv_width - 1, cfg.rnn_width)


@pytest.mark.parametrize("cur_pos", [3, 8, 13])
def test_windowed_decode_attention_matches_reference(cur_pos):
    """Stored positions in rotating order, some unseen (-10**9), some out
    of the window: masked on the stored positions, as the reference."""
    rng = np.random.default_rng(cur_pos)
    W = 8
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, W, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, W, 1, 16)).astype(np.float32)
    pos = np.stack([(cur_pos - W + 1 + np.arange(W)) for _ in range(2)])
    pos = np.where(pos >= 0, pos, -10**9).astype(np.int32)
    pos[1, 2] = cur_pos - W          # one step too old: masked
    pos = np.roll(pos, cur_pos % W, axis=1)
    got = griffin._windowed_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), torch.tensor(cur_pos, dtype=torch.int32), W)
    want = ref_griffin._windowed_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.int32(cur_pos), W)
    _close(got, want, LAYER_TOL)


# --------------------------------------------------------------------------
# the model against the reference
# --------------------------------------------------------------------------
def test_forward_loss_and_gradient_match_reference():
    """S = 12 > window 8: the windowed mask in the forward."""
    cfg, rcfg, rparams, params, data = _pair()
    model, rmodel = build_model(cfg), ref_models.build_model(rcfg)
    with torch.no_grad():
        hidden = griffin.griffin_forward(
            params, torch.from_numpy(data["tokens"]), cfg)
    _close_rel(hidden, ref_griffin.griffin_forward(
        rparams, jnp.asarray(data["tokens"]), rcfg), MODEL_TOL)
    for p in _leaves(params):
        p.requires_grad_()
    loss = model.loss(params, {k: torch.from_numpy(v)
                               for k, v in data.items()})
    loss.backward()
    rloss, rgrad = jax.value_and_grad(rmodel.loss)(
        rparams, {k: jnp.asarray(v) for k, v in data.items()})
    _close_rel(loss, rloss, MODEL_TOL)
    flat = dict(jax.tree_util.tree_flatten_with_path(rgrad)[0])
    assert len(flat) == len(_leaves(params))
    for keypath, want in flat.items():
        node = params
        for k in keypath:
            node = node[k.key]
        assert node.grad is not None, keypath
        if np.abs(np.asarray(want)).max() == 0:
            assert not node.grad.any(), keypath
        else:
            _close_rel(node.grad, want, MODEL_TOL, what=str(keypath))


@pytest.mark.parametrize("seq", [5, 8, 13])
def test_prefill_and_every_cache_field_match_reference(seq):
    """S < W (unseen slots: the last position's K / V, position -10**9),
    S = W, and S > W with S % W != 0 (the buffer in rotating order)."""
    cfg, rcfg, rparams, params, data = _pair(seq=seq)
    with torch.no_grad():
        logits, cache = build_model(cfg).prefill(
            params, {"tokens": torch.from_numpy(data["tokens"])})
    rlogits, rcache = ref_models.build_model(rcfg).prefill(
        rparams, {"tokens": jnp.asarray(data["tokens"])})
    _close_rel(logits, rlogits, MODEL_TOL)
    _assert_cache(cache, rcache, f"S={seq}")
    attn = [li for li in range(cfg.num_layers) if griffin._is_attn(cfg, li)]
    assert attn == [2]
    unseen = (cache.pos[attn[0]] == -10**9).sum(-1)
    assert (unseen == max(0, cfg.window - seq)).all()


@pytest.mark.parametrize("seq", [6, 12])
def test_three_decode_steps_match_reference(seq):
    """From S = 6 the steps write positions 6, 7, 8: the last wraps the
    window's buffer (slot 0); from S = 12 they overwrite slots 4, 5, 6."""
    cfg, rcfg, rparams, params, data = _pair(seq=seq)
    model, rmodel = build_model(cfg), ref_models.build_model(rcfg)
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(data["tokens"])})
    rlogits, rcache = rmodel.prefill(
        rparams, {"tokens": jnp.asarray(data["tokens"])})
    for step in range(3):
        nxt = np.array(jnp.argmax(rlogits, -1)[:, None].astype(jnp.int32))
        with torch.no_grad():
            logits, cache = model.decode_step(params, cache,
                                              torch.from_numpy(nxt))
        rlogits, rcache = rmodel.decode_step(rparams, rcache,
                                             jnp.asarray(nxt))
        _close_rel(logits, rlogits, MODEL_TOL, what=f"step {step}")
        _assert_cache(cache, rcache, f"step {step}")
    if seq == 6:
        assert int(cache.pos[2, 0, 0]) == 8


def test_decode_returns_a_new_cache_and_leaves_its_argument():
    """The step returns a new cache, as every family's does, and leaves the
    one it was given as it was: an attention layer's h and conv tail and a
    recurrent layer's K, V and positions pass into the new cache
    unchanged."""
    cfg, _, _, params, data = _pair(seq=6)
    model = build_model(cfg)
    with torch.no_grad():
        _, cache = model.prefill(params,
                                 {"tokens": torch.from_numpy(data["tokens"])})
        before = {f: getattr(cache, f).clone() for f in CACHE_FIELDS}
        _, new = model.decode_step(params, cache,
                                   torch.from_numpy(data["tokens"][:, :1]))
    for f in CACHE_FIELDS:
        assert getattr(new, f) is not getattr(cache, f), f
        assert torch.equal(getattr(cache, f), before[f]), f
    assert int(cache.length) == 6 and int(new.length) == 7
    rec, attn = [0, 1, 3, 4], [2]
    for f in ("k", "v", "pos"):
        assert torch.equal(getattr(new, f)[rec], before[f][rec]), f
        assert not torch.equal(getattr(new, f)[attn], before[f][attn]), f
    for f in ("h", "conv"):
        assert torch.equal(getattr(new, f)[attn], before[f][attn]), f
        assert not torch.equal(getattr(new, f)[rec], before[f][rec]), f


@pytest.mark.parametrize("seq,steps", [(5, 1), (7, 3), (12, 1), (13, 2)])
def test_prefill_then_decode_equals_a_longer_prefill(seq, steps):
    """The reference's consistency test on the port (rtol = atol = 2e-3):
    prefill(S) + decode steps against prefill(S + steps); (7, 3) crosses
    the window."""
    cfg, _, _, params, data = _pair(seq=seq + steps)
    model = build_model(cfg)
    tok = torch.from_numpy(data["tokens"])
    with torch.no_grad():
        a, cache = model.prefill(params, {"tokens": tok[:, :seq]})
        for i in range(steps):
            a, cache = model.decode_step(params, cache,
                                         tok[:, seq + i:seq + i + 1])
        b, full = model.prefill(params, {"tokens": tok})
    np.testing.assert_allclose(_np(a), _np(b), rtol=CONSISTENCY_TOL,
                               atol=CONSISTENCY_TOL)
    np.testing.assert_array_equal(_np(cache.pos), _np(full.pos))
    np.testing.assert_allclose(_np(cache.h), _np(full.h),
                               rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)


def test_chunked_windowed_prefill_at_2048_matches_reference(monkeypatch):
    """S = 2048 takes the chunked attention with the window (2048 > 1024,
    a multiple of both chunks) in both packages: logits and cache."""
    cfg, rcfg, rparams, params, data = _pair(seq=2048)
    data = {"tokens": data["tokens"][:1]}
    assert transformer._window(cfg, 0) == cfg.window == 8

    def refuse(*a, **k):
        raise AssertionError("S = 2048 took the plain attention")
    monkeypatch.setattr(layers, "_plain_attention", refuse)
    with torch.no_grad():
        logits, cache = build_model(cfg).prefill(
            params, {"tokens": torch.from_numpy(data["tokens"])})
    rlogits, rcache = ref_models.build_model(rcfg).prefill(
        rparams, {"tokens": jnp.asarray(data["tokens"])})
    _close_rel(logits, rlogits, MODEL_TOL)
    _assert_cache(cache, rcache, "S=2048")


def test_main_path_takes_the_doubling_scan(monkeypatch):
    """Forward, prefill and loss never reach the sequential loop."""
    cfg, _, _, params, data = _pair()

    def refuse(*a, **k):
        raise AssertionError("the main path fell back to the loop")
    monkeypatch.setattr(griffin, "_rglru_loop", refuse)
    model = build_model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    for p in _leaves(params):
        p.requires_grad_()
    model.loss(params, batch).backward()
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": batch["tokens"]})
        model.decode_step(params, cache, batch["tokens"][:, :1])


def test_remat_changes_no_value():
    cfg, _, _, params, data = _pair()
    grads, losses = [], []
    for remat in (False, True):
        model = build_model(cfg.replace(remat=remat))
        live = tree_from_numpy(_to_numpy(params), device=CPU)
        leaves = _leaves(live)
        for p in leaves:
            p.requires_grad_()
        loss = model.loss(live, {k: torch.from_numpy(v)
                                 for k, v in data.items()})
        loss.backward()
        losses.append(loss.detach())
        grads.append([p.grad for p in leaves])
    assert torch.equal(*losses)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_bf16_keeps_the_rounded_recurrent_state():
    """In bf16 the float32 h of the cache holds bf16 values (the reference
    rounds h to the activation dtype before keeping it); the cache's
    size does not depend on max_len."""
    cfg, _, _, params, data = _pair()
    cfg16 = cfg.replace(dtype_act=torch.bfloat16,
                        dtype_param=torch.bfloat16)
    p16 = tree_from_numpy(_to_numpy(params), dtype=torch.bfloat16,
                          device=CPU)
    model = build_model(cfg16)
    with torch.no_grad():
        logits, cache = model.prefill(
            p16, {"tokens": torch.from_numpy(data["tokens"])})
        logits, cache = model.decode_step(
            p16, cache, torch.from_numpy(data["tokens"][:, :1]))
    assert cache.h.dtype == torch.float32 and cache.k.dtype == torch.bfloat16
    assert torch.equal(cache.h, cache.h.to(torch.bfloat16).float())
    assert torch.isfinite(logits.float()).all()
    small = model.init_cache(2, 16, device=CPU)
    large = model.init_cache(2, 1 << 20, device=CPU)
    for f in CACHE_FIELDS:
        assert getattr(small, f).shape == getattr(large, f).shape


def test_count_params_at_both_configs():
    for get, rget in ((get_config, ref_configs.get_config),
                      (get_smoke_config, ref_configs.get_smoke_config)):
        cfg, rcfg = get(ARCH), rget(ARCH)
        assert count_params(cfg) == cfg.param_count == \
            ref_models.count_params(rcfg)
        assert build_model(cfg).param_table == \
            ref_models.build_model(rcfg).param_table
    # both branches in every layer: 3.42 B against the published 2.7 B
    assert count_params(get_config(ARCH)) == 3_416_471_040


def test_init_draws_the_reference_zero_rule():
    """Zero exactly where the reference's init is zero (by name: ba, bi
    and the MLP's norm-free paths; conv_b and the branch norms at 0.02)."""
    cfg = get_smoke_config(ARCH)
    params = build_model(cfg).init(torch.Generator(device=CPU).manual_seed(0))
    rparams = ref_models.build_model(ref_configs.get_smoke_config(
        ARCH)).init(jax.random.PRNGKey(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(rparams)[0])
    assert len(_leaves(params)) == len(flat)
    for keypath, want in flat.items():
        node = params
        for k in keypath:
            node = node[k.key]
        assert node.shape == want.shape
        assert bool((node == 0).all()) == bool((np.asarray(want) == 0).all())
    assert (params["layers"]["rec"]["ba"] == 0).all()
    assert (params["layers"]["rec"]["conv_b"] != 0).any()


# --------------------------------------------------------------------------
# the committed fixture (what the card is held against)
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_npz():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_reference_griffin", FIXTURE.parent / "make_reference_griffin.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


def test_port_against_the_committed_fixture(reference_npz):
    r = reference_npz
    params = tree_from_numpy({k.split("/", 1)[1]: v for k, v in r.items()
                              if k.startswith("params/")}, device=CPU)
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    data = {k: torch.from_numpy(r[k]) for k in ("tokens", "labels")}
    prompt = int(r["cache_length"])
    with torch.no_grad():
        _close_rel(griffin.griffin_forward(params, data["tokens"], cfg),
                   r["hidden"], MODEL_TOL)
        _close_rel(model.loss(params, data), r["loss"], MODEL_TOL)
        logits, cache = model.prefill(
            params, {"tokens": data["tokens"][:, :prompt]})
        _close_rel(logits, r["prefill_logits"], MODEL_TOL)
        for prefix in ("cache_", "final_cache_"):
            for field in CACHE_FIELDS:
                want = r[prefix + field]
                got = getattr(cache, field)
                if field == "pos":
                    np.testing.assert_array_equal(_np(got), want)
                elif np.abs(want).max() == 0:
                    assert not _np(got).any()
                else:
                    _close_rel(got, want, MODEL_TOL, what=prefix + field)
            assert int(cache.length) == int(r[prefix + "length"])
            if prefix == "cache_":
                for fed, want in zip(r["decode_tokens"], r["decode_logits"]):
                    logits, cache = model.decode_step(
                        params, cache, torch.from_numpy(fed))
                    _close_rel(logits, want, MODEL_TOL)


def test_committed_fixture_is_the_reference_output(reference_npz):
    """The parameters the reference draws and its outputs on the stored
    inputs, regenerated through JAX, equal the file's."""
    gen = _generator()
    r = reference_npz
    cfg = ref_configs.get_smoke_config(ARCH)
    params = ref_models.build_model(cfg).init(jax.random.PRNGKey(gen.SEED))
    for k, v in gen.flatten(params).items():
        np.testing.assert_array_equal(r[f"params/{k}"], v)
    data = {k: r[k] for k in ("tokens", "labels")}
    for k, v in gen.outputs(params, cfg, data).items():
        np.testing.assert_allclose(r[k], v, rtol=0, atol=1e-6 * max(
            1.0, float(np.abs(v).max())), err_msg=k)
    assert math.isfinite(float(r["loss"]))
    assert int(r["final_cache_pos"][2, 0, 0]) == 8   # the window wrapped
