"""PyTorch port, the LM zoo's RWKV-6 family (``repro_torch.configs``,
``repro_torch.data.tokens``, ``repro_torch.models.{layers,rwkv,registry}``),
held against ``repro`` on the same numpy inputs, with the reference's
smoke parameters carried across by ``convert.tree_from_numpy``.

Everything here is float32 in both packages, whose summation orders differ.
Tolerances: the layers 1e-6 (relative to max(1, |reference|)); the WKV
recurrences 1e-5 and the port's chunked path against its scan 2e-4 (the
reference's own band for the two paths); the model's outputs and gradient
1e-5 of max|reference|; the committed fixture 1e-5 of max|reference|.
"""
import dataclasses
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.models as ref_models  # noqa: E402
import repro.models.layers as ref_layers  # noqa: E402
import repro.models.rwkv as ref_rwkv  # noqa: E402
from repro.data import TokenPipeline as RefTokenPipeline  # noqa: E402
from repro_torch import tree_from_numpy  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, ModelConfig,  # noqa: E402
                                 get_config, get_smoke_config,
                                 resolve_dtype, shape_applicable)
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.models import (build_model, chunked_ce_loss,  # noqa: E402
                                count_params, layer_norm, make_input_specs)
from repro_torch.models import rwkv  # noqa: E402

CPU = "cpu"
LAYER_TOL = 1e-6
WKV_TOL = 1e-5
WKV_PATHS_TOL = 2e-4
MODEL_TOL = 1e-5
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "reference_rwkv.npz"
# (S, rwkv_chunk): the scan path and the chunk-parallel path
PATHS = {"scan": (12, 0), "chunked": (32, 16)}


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


# --------------------------------------------------------------------------
# configs and the token stream
# --------------------------------------------------------------------------
def _dtype_name(d) -> str:
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) \
        else np.dtype(d).name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_the_reference_field_for_field(arch):
    """CONFIG and SMOKE of every architecture: every field equal, the
    dtypes by name (the reference mixes jnp.bfloat16 and "float32")."""
    for ours, ref in ((get_config(arch), ref_configs.get_config(arch)),
                      (get_smoke_config(arch),
                       ref_configs.get_smoke_config(arch))):
        names = [f.name for f in dataclasses.fields(ModelConfig)]
        assert names == [f.name for f in dataclasses.fields(type(ref))]
        for name in names:
            a, b = getattr(ours, name), getattr(ref, name)
            if name.startswith("dtype_"):
                assert isinstance(a, torch.dtype)
                assert _dtype_name(a) == _dtype_name(b), (arch, name)
            else:
                assert a == b, (arch, name, a, b)
    assert ARCH_IDS == ref_configs.ARCH_IDS
    assert SHAPES == {k: type(SHAPES[k])(**dataclasses.asdict(v))
                      for k, v in ref_configs.SHAPES.items()}
    for shape in SHAPES:
        assert shape_applicable(arch, shape) == \
            ref_configs.shape_applicable(arch, shape)


def test_resolve_dtype():
    assert resolve_dtype("float32") is torch.float32
    assert resolve_dtype(torch.bfloat16) is torch.bfloat16
    assert resolve_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError):
        resolve_dtype("float31")
    cfg = get_config("rwkv6_1b6").replace(dtype_act="float32")
    assert cfg.dtype_act is torch.float32 and cfg.dtype_param is torch.bfloat16


@pytest.mark.parametrize("step,shard,num_shards", [
    (0, 0, 1), (7, 0, 1), (10_000, 0, 1), (3, 1, 2), (5, 3, 4)])
def test_token_pipeline_is_bit_equal(step, shard, num_shards):
    for vocab, batch, seq, seed in ((293, 8, 32, 0), (65_536, 8, 16, 3)):
        ours = TokenPipeline(vocab, batch, seq, seed=seed)
        ref = RefTokenPipeline(vocab, batch, seq, seed=seed)
        for a, b in zip(ours.batch_at(step, shard, num_shards),
                        ref.batch_at(step, shard, num_shards)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(24).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                     torch.from_numpy(bias))
    want = ref_layers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias))
    assert got.dtype == torch.float32
    _close(got, want, LAYER_TOL)
    # bf16 in, bf16 out, computed in float32
    got16 = layer_norm(torch.from_numpy(x).to(torch.bfloat16),
                       torch.from_numpy(scale), torch.from_numpy(bias))
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("S,chunk,cap,ignore", [
    (16, 4, None, False),      # four chunks
    (16, 4, None, True),       # labels -1 ignored
    (12, 5, 30.0, True),       # S % chunk != 0: one chunk; a logit cap
    (8, 512, None, False)])    # chunk > S
def test_chunked_ce_loss_matches_reference(S, chunk, cap, ignore):
    rng = np.random.default_rng(S + chunk)
    x = rng.standard_normal((2, S, 16)).astype(np.float32)
    embed = rng.standard_normal((37, 16)).astype(np.float32) * 2
    labels = rng.integers(0, 37, (2, S)).astype(np.int32)
    if ignore:
        labels[rng.random((2, S)) < 0.3] = -1
    got = chunked_ce_loss(torch.from_numpy(x), torch.from_numpy(embed),
                          torch.from_numpy(labels), chunk=chunk,
                          logit_cap=cap)
    want = ref_layers.chunked_ce_loss(jnp.asarray(x), jnp.asarray(embed),
                                      jnp.asarray(labels), chunk=chunk,
                                      logit_cap=cap)
    _close(got, want, LAYER_TOL)
    # the gradient through the recomputed chunks
    xt = torch.from_numpy(x).requires_grad_()
    chunked_ce_loss(xt, torch.from_numpy(embed), torch.from_numpy(labels),
                    chunk=chunk, logit_cap=cap).backward()
    gref = jax.grad(lambda a: ref_layers.chunked_ce_loss(
        a, jnp.asarray(embed), jnp.asarray(labels), chunk=chunk,
        logit_cap=cap))(jnp.asarray(x))
    _close(xt.grad, gref, LAYER_TOL)


def test_chunked_ce_loss_all_ignored_is_zero():
    x = torch.ones((1, 4, 3))
    labels = torch.full((1, 4), -1, dtype=torch.int32)
    assert float(chunked_ce_loss(x, torch.ones((5, 3)), labels)) == 0.0


# --------------------------------------------------------------------------
# the wkv recurrence, both paths
# --------------------------------------------------------------------------
def _wkv_inputs(decay_scale, B=2, S=64, H=2, N=8):
    rng = np.random.default_rng(int(decay_scale * 10))
    D = H * N
    r, k, v = (rng.standard_normal((B, S, D)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(decay_scale * rng.standard_normal((B, S, D))
                       - 2)).astype(np.float32)
    u = (rng.standard_normal(D) * 0.3).astype(np.float32)
    state0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    return (r, k, v, w, u), state0, H, N


@pytest.mark.parametrize("decay_scale", [0.5, 8.0])
def test_wkv_scan_matches_reference(decay_scale):
    arrays, s0, H, N = _wkv_inputs(decay_scale)
    y, st = rwkv._wkv_scan(*map(torch.from_numpy, arrays), H, N,
                           torch.from_numpy(s0))
    ry, rst = ref_rwkv._wkv_scan(*map(jnp.asarray, arrays), H, N,
                                 jnp.asarray(s0))
    _close_rel(y, ry, WKV_TOL)
    _close_rel(st, rst, WKV_TOL)


@pytest.mark.parametrize("decay_scale", [0.5, 8.0])
def test_wkv_chunked_matches_reference(decay_scale):
    arrays, s0, H, N = _wkv_inputs(decay_scale)
    y, st = rwkv._wkv_chunked(*map(torch.from_numpy, arrays), H, N, 16,
                              torch.from_numpy(s0))
    ry, rst = ref_rwkv._wkv_chunked(*map(jnp.asarray, arrays), H, N, 16,
                                    jnp.asarray(s0))
    _close_rel(y, ry, WKV_TOL)
    _close_rel(st, rst, WKV_TOL)


@pytest.mark.parametrize("decay_scale", [0.5, 8.0])
def test_wkv_chunked_matches_scan(decay_scale):
    """The reference's test of its two paths, on the port."""
    arrays, s0, H, N = _wkv_inputs(decay_scale)
    t = list(map(torch.from_numpy, arrays))
    y_s, st_s = rwkv._wkv_scan(*t, H, N, torch.from_numpy(s0))
    y_c, st_c = rwkv._wkv_chunked(*t, H, N, 16, torch.from_numpy(s0))
    np.testing.assert_allclose(_np(y_c), _np(y_s), rtol=WKV_PATHS_TOL,
                               atol=WKV_PATHS_TOL)
    np.testing.assert_allclose(_np(st_c), _np(st_s), rtol=WKV_PATHS_TOL,
                               atol=WKV_PATHS_TOL)


# --------------------------------------------------------------------------
# the model against the reference
# --------------------------------------------------------------------------
def _pair(path, key=0):
    """(port cfg, reference cfg, reference params, port params, tokens,
    labels) on one WKV path."""
    S, chunk = PATHS[path]
    cfg = get_smoke_config("rwkv6_1b6").replace(rwkv_chunk=chunk)
    rcfg = ref_configs.get_smoke_config("rwkv6_1b6").replace(rwkv_chunk=chunk)
    rparams = ref_models.build_model(rcfg).init(jax.random.PRNGKey(key))
    params = tree_from_numpy(jax.tree_util.tree_map(np.asarray, rparams),
                             device=CPU)
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    labels[0, :3] = -1
    return cfg, rcfg, rparams, params, tokens, labels


@pytest.mark.parametrize("path", list(PATHS))
def test_forward_loss_and_gradient_match_reference(path):
    cfg, rcfg, rparams, params, tokens, labels = _pair(path)
    model, rmodel = build_model(cfg), ref_models.build_model(rcfg)
    tok = torch.from_numpy(tokens)
    _close_rel(rwkv.rwkv_forward(params, tok, cfg),
               ref_rwkv.rwkv_forward(rparams, jnp.asarray(tokens), rcfg),
               MODEL_TOL)
    batch = {"tokens": tok, "labels": torch.from_numpy(labels)}
    rbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    live = params
    for p in _leaves(live):
        p.requires_grad_()
    loss = model.loss(live, batch)
    loss.backward()
    rloss, rgrad = jax.value_and_grad(rmodel.loss)(rparams, rbatch)
    _close_rel(loss, rloss, MODEL_TOL)
    flat = dict(jax.tree_util.tree_flatten_with_path(rgrad)[0])
    for keypath, want in flat.items():
        node = live
        for k in keypath:
            node = node[k.key]
        assert node.grad is not None, keypath
        _close_rel(node.grad, want, MODEL_TOL, what=str(keypath))


@pytest.mark.parametrize("path", list(PATHS))
def test_prefill_cache_and_decode_match_reference(path):
    cfg, rcfg, rparams, params, tokens, _ = _pair(path)
    model, rmodel = build_model(cfg), ref_models.build_model(rcfg)
    with torch.no_grad():
        logits, cache = model.prefill(params,
                                      {"tokens": torch.from_numpy(tokens)})
    rlogits, rcache = rmodel.prefill(rparams, {"tokens": jnp.asarray(tokens)})
    _close_rel(logits, rlogits, MODEL_TOL)
    assert cache._fields == rcache._fields
    for field in cache._fields:
        _close_rel(getattr(cache, field), getattr(rcache, field), MODEL_TOL,
                   what=field)
    assert cache.length.dtype == torch.int32 and int(cache.length) == \
        tokens.shape[1]
    for _ in range(3):
        nxt = np.array(jnp.argmax(rlogits, -1)[:, None].astype(jnp.int32))
        with torch.no_grad():
            logits, cache = model.decode_step(params, cache,
                                              torch.from_numpy(nxt))
        rlogits, rcache = rmodel.decode_step(rparams, rcache,
                                             jnp.asarray(nxt))
        _close_rel(logits, rlogits, MODEL_TOL)
        for field in cache._fields:
            _close_rel(getattr(cache, field), getattr(rcache, field),
                       MODEL_TOL, what=field)


@pytest.mark.parametrize("path", list(PATHS))
def test_prefill_then_decode_equals_a_longer_prefill(path):
    """The reference's consistency test on the port (rtol = atol = 2e-3):
    prefill(S) + one decode step against prefill(S + 1)."""
    cfg, _, _, params, tokens, _ = _pair(path)
    model = build_model(cfg)
    longer = np.concatenate([tokens, tokens[:, :1]], axis=1)
    tok = torch.from_numpy(longer)
    S = tokens.shape[1]
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": tok[:, :S]})
        a, _ = model.decode_step(params, cache, tok[:, S:])
        b, _ = model.prefill(params, {"tokens": tok})
    np.testing.assert_allclose(_np(a), _np(b), rtol=2e-3, atol=2e-3)


def test_remat_changes_no_value():
    cfg, _, _, params, tokens, labels = _pair("chunked")
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    grads = []
    for remat in (False, True):
        model = build_model(cfg.replace(remat=remat))
        live = tree_from_numpy(_to_numpy(params), device=CPU)
        leaves = _leaves(live)
        for p in leaves:
            p.requires_grad_()
        model.loss(live, batch).backward()
        grads.append([p.grad for p in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _to_numpy(tree):
    return {k: _to_numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_mixed_dtypes_promote_as_the_reference():
    """bf16 activations against float32 weights: the port promotes, as
    JAX does, where torch.einsum alone would refuse."""
    cfg, _, _, params, tokens, labels = _pair("scan")
    cfg16 = cfg.replace(dtype_act=torch.bfloat16)
    out = rwkv.rwkv_forward(params, torch.from_numpy(tokens), cfg16)
    assert torch.isfinite(out.float()).all()


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------
def test_count_params_equals_the_reference():
    for get in (get_config, get_smoke_config):
        cfg = get("rwkv6_1b6")
        want = ref_models.count_params(
            (ref_configs.get_config if get is get_config
             else ref_configs.get_smoke_config)("rwkv6_1b6"))
        assert count_params(cfg) == cfg.param_count == want
    assert count_params(get_config("rwkv6_1b6")) == 1_599_873_024


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_builds_the_reference_table(arch):
    """build_model builds all ten configs, published and smoke: the
    reference's parameter table, entry for entry."""
    for get, rget in ((get_config, ref_configs.get_config),
                      (get_smoke_config, ref_configs.get_smoke_config)):
        model = build_model(get(arch))
        assert model.param_table == \
            ref_models.build_model(rget(arch)).param_table
        assert count_params(get(arch)) == ref_models.count_params(rget(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    cfg = get_config(arch)
    rcfg = ref_configs.get_config(arch)
    for shape in SHAPES.values():
        ours = make_input_specs(cfg, shape)
        ref = ref_models.make_input_specs(rcfg, ref_configs.SHAPES[shape.name])
        assert set(ours) == set(ref)
        for k, spec in ours.items():
            assert spec.shape == ref[k].shape
            assert _dtype_name(spec.dtype) == _dtype_name(ref[k].dtype)


def test_init_draws_the_table_on_the_generator_device():
    cfg = get_smoke_config("rwkv6_1b6")
    model = build_model(cfg)
    gen = torch.Generator(device=CPU).manual_seed(0)
    params = model.init(gen)
    again = model.init(torch.Generator(device=CPU).manual_seed(0))
    ref = ref_models.build_model(ref_configs.get_smoke_config("rwkv6_1b6"))
    rparams = ref.init(jax.random.PRNGKey(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(rparams)[0])
    assert len(_leaves(params)) == len(flat)
    for keypath, want in flat.items():
        node, other = params, again
        for k in keypath:
            node, other = node[k.key], other[k.key]
        assert node.shape == want.shape and node.dtype == torch.float32
        assert torch.equal(node, other)
        # the reference's rules by name: zeros where its draw is zero
        assert bool((node == 0).all()) == bool((np.asarray(want) == 0).all())
    cache = model.init_cache(3, device=CPU)
    assert cache.state.shape == (2, 3, 4, 16, 16) and int(cache.length) == 0


# --------------------------------------------------------------------------
# the committed fixture (what the card is held against)
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_npz():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("path,chunk", [("scan", 0), ("chunk", 16)])
def test_port_against_the_committed_fixture(reference_npz, path, chunk):
    ref = reference_npz
    params = tree_from_numpy({k.split("/", 1)[1]: v for k, v in ref.items()
                              if k.startswith("params/")}, device=CPU)
    r = {k.split("/", 1)[1]: v for k, v in ref.items()
         if k.startswith(path + "/")}
    cfg = get_smoke_config("rwkv6_1b6").replace(rwkv_chunk=chunk)
    model = build_model(cfg)
    tokens = torch.from_numpy(r["tokens"])
    with torch.no_grad():
        hidden = rwkv.rwkv_forward(params, tokens, cfg)
        _close_rel(torch.einsum("bsd,dv->bsv", hidden, params["head"]),
                   r["logits"], MODEL_TOL)
        _close_rel(model.loss(params, {"tokens": tokens, "labels":
                                       torch.from_numpy(r["labels"])}),
                   r["loss"], MODEL_TOL)
        logits, cache = model.prefill(params, {"tokens": tokens})
        _close_rel(logits, r["prefill_logits"], MODEL_TOL)
        for field in cache._fields:
            _close_rel(getattr(cache, field), r[f"cache_{field}"], MODEL_TOL)
        for fed, want in zip(r["decode_tokens"], r["decode_logits"]):
            logits, cache = model.decode_step(params, cache,
                                              torch.from_numpy(fed))
            _close_rel(logits, want, MODEL_TOL)


def test_committed_fixture_is_the_reference_output(reference_npz):
    """The scan path's entries regenerated through JAX equal the file's."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_reference_rwkv", FIXTURE.parent / "make_reference_rwkv.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    base = ref_configs.get_smoke_config("rwkv6_1b6")
    params = ref_models.build_model(base).init(jax.random.PRNGKey(gen.SEED))
    for k, v in gen.flatten(params).items():
        np.testing.assert_array_equal(reference_npz[f"params/{k}"], v)
    rng = np.random.default_rng(gen.SEED)
    out = gen.path_outputs(params, base.replace(rwkv_chunk=0),
                           gen.PATHS["scan"]["seq"], rng)
    for k, v in out.items():
        np.testing.assert_allclose(reference_npz[f"scan/{k}"], v, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(v).max()))
