"""PyTorch port, the LM zoo's Whisper encoder-decoder (``repro_torch.models.
encdec``, ``whisper_tiny``), held against ``repro.models.encdec`` on the
same numpy inputs (frames drawn standard normal), with the reference's
smoke parameters carried across by ``convert.tree_from_numpy``.

Everything here is float32 in both packages, whose summation orders differ.
Tolerances: the sinusoid and one attention block 1e-6 (relative to max(1,
|reference|)); the encoder's output, the model's outputs, gradient and
every cache field 1e-5 of max|reference|; the committed fixture 1e-5 of
max|reference|; prefill + decode against a longer prefill the reference's
own band (rtol = atol = 2e-3).
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
import repro.models.encdec as ref_encdec  # noqa: E402
from repro_torch import tree_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import build_model, count_params  # noqa: E402
from repro_torch.models import encdec, transformer  # noqa: E402

CPU = "cpu"
ARCH = "whisper_tiny"
LAYER_TOL = 1e-6
MODEL_TOL = 1e-5
CONSISTENCY_TOL = 2e-3
FIXTURE = Path(__file__).resolve().parent / "fixtures" / \
    "reference_encdec.npz"
BATCH, SEQ = 2, 12
CACHE_FIELDS = ("k", "v", "xk", "xv")


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


def _pair(key=0, seq=SEQ, **overrides):
    """(port cfg, reference cfg, reference params, port params, numpy
    batch: frames, tokens, labels)."""
    cfg = get_smoke_config(ARCH).replace(**overrides)
    rcfg = ref_configs.get_smoke_config(ARCH).replace(**overrides)
    rparams = ref_models.build_model(rcfg).init(jax.random.PRNGKey(key))
    params = tree_from_numpy(jax.tree_util.tree_map(np.asarray, rparams),
                             device=CPU)
    rng = np.random.default_rng(seq)
    data = {"frames": rng.standard_normal(
                (BATCH, cfg.enc_frames, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size,
                                   (BATCH, seq)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size,
                                   (BATCH, seq)).astype(np.int32)}
    data["labels"][0, :3] = -1
    return cfg, rcfg, rparams, params, data


def _torch_batch(data, drop=()):
    return {k: torch.from_numpy(v) for k, v in data.items() if k not in drop}


def _jax_batch(data, drop=()):
    return {k: jnp.asarray(v) for k, v in data.items() if k not in drop}


# --------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("length,d", [(24, 64), (1500, 384), (7, 10)])
def test_sinusoid_matches_reference(length, d):
    got = encdec._sinusoid(length, d, torch.float32)
    _close(got, ref_encdec._sinusoid(length, d, jnp.float32), LAYER_TOL)
    assert encdec._sinusoid(3, d, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("causal,cross", [(False, False), (True, False),
                                          (False, True)])
def test_mha_matches_reference_and_its_bias_pattern(causal, cross):
    """Biases on q, v and the output, none on k (the table too): self
    attention bidirectional and causal, cross attention over the frames."""
    cfg, rcfg, rparams, params, data = _pair()
    name = "xattn" if cross else "attn"
    rlp = jax.tree_util.tree_map(lambda a: a[0], rparams["dec_layers"][name])
    lp = transformer._layer(params["dec_layers"], 0)[name]
    assert sorted(lp) == ["bo", "bq", "bv", "wk", "wo", "wq", "wv"]
    x = np.random.default_rng(1).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    src = data["frames"] if cross else x
    got = encdec._mha(torch.from_numpy(x), torch.from_numpy(src), lp, cfg,
                      causal)
    want = ref_encdec._mha(jnp.asarray(x), jnp.asarray(src), rlp, rcfg,
                           causal)
    _close(got, want, LAYER_TOL)
    # a bias on k would shift every score of a query alike: none is read
    lp_k = dict(lp, bk=torch.full_like(lp["bq"], 7.0))
    assert torch.equal(encdec._mha(torch.from_numpy(x),
                                   torch.from_numpy(src), lp_k, cfg,
                                   causal), got)
    table = encdec._mha_table(cfg, "p/")
    assert "p/bk" not in table and {"p/bq", "p/bv", "p/bo"} <= set(table)


# --------------------------------------------------------------------------
# the model against the reference
# --------------------------------------------------------------------------
def test_encode_forward_loss_and_gradient_match_reference():
    cfg, rcfg, rparams, params, data = _pair()
    model, rmodel = build_model(cfg), ref_models.build_model(rcfg)
    with torch.no_grad():
        enc = encdec.encode(params, torch.from_numpy(data["frames"]), cfg)
        hidden = encdec.decode_train(params, enc,
                                     torch.from_numpy(data["tokens"]), cfg)
    renc = ref_encdec.encode(rparams, jnp.asarray(data["frames"]), rcfg)
    _close_rel(enc, renc, MODEL_TOL)
    _close_rel(hidden, ref_encdec.decode_train(
        rparams, renc, jnp.asarray(data["tokens"]), rcfg), MODEL_TOL)
    for p in _leaves(params):
        p.requires_grad_()
    loss = model.loss(params, _torch_batch(data))
    loss.backward()
    rloss, rgrad = jax.value_and_grad(rmodel.loss)(rparams, _jax_batch(data))
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


def test_prefill_cache_and_three_decode_steps_match_reference():
    """The prefill's logits and k, v, xk, xv; three greedy steps, each
    leaving its argument as it was and passing the cross cache through
    uncopied."""
    cfg, rcfg, rparams, params, data = _pair()
    model, rmodel = build_model(cfg), ref_models.build_model(rcfg)
    max_len = SEQ + 4
    with torch.no_grad():
        logits, cache = model.prefill(params, _torch_batch(data, ["labels"]),
                                      max_len)
    rlogits, rcache = rmodel.prefill(rparams, _jax_batch(data, ["labels"]),
                                     max_len)
    _close_rel(logits, rlogits, MODEL_TOL)
    assert cache._fields == rcache._fields
    for field in CACHE_FIELDS:
        _close_rel(getattr(cache, field), getattr(rcache, field), MODEL_TOL,
                   what=field)
    assert not cache.k[:, :, SEQ:].any()
    assert cache.length.dtype == torch.int32 and cache.length.ndim == 0
    assert int(cache.length) == int(rcache.length) == SEQ
    for step in range(3):
        nxt = np.array(jnp.argmax(rlogits, -1)[:, None].astype(jnp.int32))
        before = cache.k.clone()
        with torch.no_grad():
            logits, new = model.decode_step(params, cache,
                                            torch.from_numpy(nxt))
        assert torch.equal(cache.k, before), "the step changed its argument"
        assert new.xk is cache.xk and new.xv is cache.xv
        cache = new
        rlogits, rcache = rmodel.decode_step(rparams, rcache,
                                             jnp.asarray(nxt))
        _close_rel(logits, rlogits, MODEL_TOL, what=f"step {step}")
        for field in CACHE_FIELDS:
            _close_rel(getattr(cache, field), getattr(rcache, field),
                       MODEL_TOL, what=f"step {step} {field}")
        assert int(cache.length) == int(rcache.length)


@pytest.mark.parametrize("seq,steps", [(SEQ, 1), (5, 3)])
def test_prefill_then_decode_equals_a_longer_prefill(seq, steps):
    """The reference's consistency test on the port (rtol = atol = 2e-3)."""
    cfg, _, _, params, data = _pair(seq=seq + steps)
    model = build_model(cfg)
    tok = torch.from_numpy(data["tokens"])
    frames = torch.from_numpy(data["frames"])
    max_len = seq + steps + 2
    with torch.no_grad():
        a, cache = model.prefill(params, {"tokens": tok[:, :seq],
                                          "frames": frames}, max_len)
        for i in range(steps):
            a, cache = model.decode_step(params, cache,
                                         tok[:, seq + i:seq + i + 1])
        b, full = model.prefill(params, {"tokens": tok, "frames": frames},
                                max_len)
    np.testing.assert_allclose(_np(a), _np(b), rtol=CONSISTENCY_TOL,
                               atol=CONSISTENCY_TOL)
    np.testing.assert_allclose(_np(cache.k), _np(full.k),
                               rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)


def test_cache_write_clamps_at_max_len():
    """A decode step at length = max_len writes its K / V at the last
    position (XLA's dynamic_update_slice clamp) and reads dec_pos at
    length: the reference's numbers, not an error."""
    cfg, rcfg, rparams, params, data = _pair()
    model, rmodel = build_model(cfg), ref_models.build_model(rcfg)
    with torch.no_grad():
        _, cache = model.prefill(params, _torch_batch(data, ["labels"]), SEQ)
    _, rcache = rmodel.prefill(rparams, _jax_batch(data, ["labels"]), SEQ)
    nxt = data["tokens"][:, :1]
    for _ in range(2):      # length = max_len, then max_len + 1
        with torch.no_grad():
            logits, cache = model.decode_step(params, cache,
                                              torch.from_numpy(nxt))
        rlogits, rcache = rmodel.decode_step(rparams, rcache,
                                             jnp.asarray(nxt))
        _close_rel(logits, rlogits, MODEL_TOL)
        _close_rel(cache.k, rcache.k, MODEL_TOL)
    assert int(cache.length) == SEQ + 2
    with torch.no_grad():
        _, fresh = model.prefill(params, _torch_batch(data, ["labels"]), SEQ)
    assert torch.equal(cache.k[:, :, :-1], fresh.k[:, :, :-1])
    assert not torch.equal(cache.k[:, :, -1], fresh.k[:, :, -1])


def test_prompt_longer_than_max_len_is_refused():
    cfg, _, _, params, data = _pair()
    with pytest.raises(ValueError, match="max_len"):
        build_model(cfg).prefill(params, _torch_batch(data, ["labels"]),
                                 SEQ - 1)


def test_remat_changes_no_value():
    cfg, _, _, params, data = _pair()
    grads, losses = [], []
    for remat in (False, True):
        model = build_model(cfg.replace(remat=remat))
        live = tree_from_numpy(_to_numpy(params), device=CPU)
        leaves = _leaves(live)
        for p in leaves:
            p.requires_grad_()
        loss = model.loss(live, _torch_batch(data))
        loss.backward()
        losses.append(loss.detach())
        grads.append([p.grad for p in leaves])
    assert torch.equal(*losses)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_bf16_frames_and_cache():
    """bf16 activations over float32 frames: the cache in bf16, finite
    logits."""
    cfg, _, _, params, data = _pair()
    cfg16 = cfg.replace(dtype_act=torch.bfloat16, dtype_param=torch.bfloat16)
    p16 = tree_from_numpy(_to_numpy(params), dtype=torch.bfloat16,
                          device=CPU)
    model = build_model(cfg16)
    with torch.no_grad():
        logits, cache = model.prefill(p16, _torch_batch(data, ["labels"]),
                                      SEQ + 1)
        logits, cache = model.decode_step(
            p16, cache, torch.from_numpy(data["tokens"][:, :1]))
    assert all(getattr(cache, f).dtype == torch.bfloat16
               for f in CACHE_FIELDS)
    assert torch.isfinite(logits.float()).all()


def test_count_params_and_the_table():
    """49.06 M at the published config, 32768 rows of dec_pos among them;
    the init's zeros where the reference's are (by name)."""
    for get, rget in ((get_config, ref_configs.get_config),
                      (get_smoke_config, ref_configs.get_smoke_config)):
        cfg, rcfg = get(ARCH), rget(ARCH)
        assert count_params(cfg) == cfg.param_count == \
            ref_models.count_params(rcfg)
        assert build_model(cfg).param_table == \
            ref_models.build_model(rcfg).param_table
    assert count_params(get_config(ARCH)) == 49_060_224
    assert build_model(get_config(ARCH)).param_table["dec_pos"][0] == \
        (32768, 384)
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
    assert (params["dec_layers"]["ln1"] == 0).all()
    assert (params["dec_layers"]["ln1_b"] != 0).any()


# --------------------------------------------------------------------------
# the committed fixture (what the card is held against)
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_npz():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_reference_encdec", FIXTURE.parent / "make_reference_encdec.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


def test_port_against_the_committed_fixture(reference_npz):
    r = reference_npz
    cfg = get_smoke_config(ARCH)
    rows = build_model(cfg).param_table["dec_pos"][0][0]
    params = tree_from_numpy(_generator().full_params(
        {k.split("/", 1)[1]: v for k, v in r.items()
         if k.startswith("params/")}, rows), device=CPU)
    model = build_model(cfg)
    data = {k: torch.from_numpy(r[k]) for k in ("frames", "tokens",
                                                "labels")}
    with torch.no_grad():
        enc = encdec.encode(params, data["frames"], cfg)
        _close_rel(enc, r["encoded"], MODEL_TOL)
        _close_rel(encdec.decode_train(params, enc, data["tokens"], cfg),
                   r["hidden"], MODEL_TOL)
        _close_rel(model.loss(params, data), r["loss"], MODEL_TOL)
        logits, cache = model.prefill(
            params, {k: v for k, v in data.items() if k != "labels"},
            r["cache_k"].shape[2])
        _close_rel(logits, r["prefill_logits"], MODEL_TOL)
        for field in CACHE_FIELDS:
            _close_rel(getattr(cache, field), r[f"cache_{field}"], MODEL_TOL)
        assert int(cache.length) == int(r["cache_length"])
        for fed, want in zip(r["decode_tokens"], r["decode_logits"]):
            logits, cache = model.decode_step(params, cache,
                                              torch.from_numpy(fed))
            _close_rel(logits, want, MODEL_TOL)


def test_committed_fixture_is_the_reference_output(reference_npz):
    """The parameters the reference draws (dec_pos cut to the rows the
    outputs read) and its outputs on the stored inputs, regenerated
    through JAX, equal the file's; the padded rows are never read."""
    gen = _generator()
    r = reference_npz
    cfg = ref_configs.get_smoke_config(ARCH)
    params = ref_models.build_model(cfg).init(jax.random.PRNGKey(gen.SEED))
    stored = gen.stored_params(params)
    assert set(stored) == {k.split("/", 1)[1] for k in r
                           if k.startswith("params/")}
    for k, v in stored.items():
        np.testing.assert_array_equal(r[f"params/{k}"], v)
    data = {k: r[k] for k in ("frames", "tokens", "labels")}
    padded = jax.tree_util.tree_map(jnp.asarray, dict(
        params, dec_pos=gen.full_params(stored, params["dec_pos"].shape[0])[
            "dec_pos"]))
    fresh = gen.outputs(params, cfg, data)
    for k, v in fresh.items():
        np.testing.assert_allclose(r[k], v, rtol=0, atol=1e-6 * max(
            1.0, float(np.abs(v).max())), err_msg=k)
    for k, v in gen.outputs(padded, cfg, data).items():
        np.testing.assert_array_equal(fresh[k], v, err_msg=f"padded {k}")
    assert math.isfinite(float(r["loss"]))
