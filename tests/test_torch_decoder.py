"""PyTorch port, the LM zoo's decoder family (``repro_torch.models.
{layers,moe,transformer,registry}``: dense, VLM prefix, MoE), held against
``repro`` on the same numpy inputs, with the reference's smoke parameters
carried across by ``convert.tree_from_numpy``.

Everything here is float32 in both packages, whose summation orders differ.
Tolerances: the layers 1e-6 (relative to max(1, |reference|)); ``moe_ffn``
1e-6 of max|reference| and its routing (experts, slots, drops) equal; the
model's outputs, gradient and cache 1e-5 of max|reference|; the committed
fixture 1e-5 of max|reference|; prefill + decode against a longer prefill
the reference's own band (rtol = atol = 2e-3).
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
import repro.models.layers as ref_layers  # noqa: E402
import repro.models.moe as ref_moe  # noqa: E402
import repro.models.transformer as ref_tf  # noqa: E402
from repro_torch import tree_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import (active_params, apply_rope,  # noqa: E402
                                build_model, count_params, decode_attention,
                                mlp, rope)
from repro_torch.models import moe, transformer  # noqa: E402

CPU = "cpu"
LAYER_TOL = 1e-6
MOE_TOL = 1e-6
MODEL_TOL = 1e-5
CONSISTENCY_TOL = 2e-3
ARCHS = ("stablelm_12b", "nemotron4_15b", "phi3_medium_14b", "qwen2_72b",
         "llava_next_mistral_7b", "qwen3_moe_235b", "arctic_480b")
FIXTURE = Path(__file__).resolve().parent / "fixtures" / \
    "reference_decoder.npz"
BATCH, SEQ = 2, 12


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


# --------------------------------------------------------------------------
# rotary embeddings and decode attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("head_dim,theta", [(16, 10_000.0), (10, 10_000.0),
                                            (160, 10_000.0),
                                            (128, 1_000_000.0)])
def test_rope_and_apply_rope_match_reference(head_dim, theta):
    """Float32 angles at positions 0..63 and at (B, S) positions; the
    rotation of bf16 and float32 heads, cast back."""
    pos = np.arange(64)
    cos, sin = rope(torch.from_numpy(pos), head_dim, theta)
    rcos, rsin = ref_layers.rope(jnp.asarray(pos), head_dim, theta)
    assert cos.dtype == torch.float32 and cos.shape == (64, head_dim // 2)
    _close(cos, rcos, LAYER_TOL)
    _close(sin, rsin, LAYER_TOL)
    bpos = np.array([[3, 4, 5], [40, 41, 42]])
    bcos, bsin = rope(torch.from_numpy(bpos), head_dim, theta)
    rbcos, rbsin = ref_layers.rope(jnp.asarray(bpos), head_dim, theta)
    _close(bcos, rbcos, LAYER_TOL)
    _close(bsin, rbsin, LAYER_TOL)
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 64, 3, head_dim)).astype(np.float32)
    got = apply_rope(torch.from_numpy(x), cos, sin)
    want = ref_layers.apply_rope(jnp.asarray(x), rcos, rsin)
    _close(got, want, LAYER_TOL)
    xb = x[:, :3]
    _close(apply_rope(torch.from_numpy(xb), bcos, bsin),
           ref_layers.apply_rope(jnp.asarray(xb), rbcos, rbsin), LAYER_TOL)
    got16 = apply_rope(torch.from_numpy(x).to(torch.bfloat16), cos, sin)
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("cache_len,window", [(1, None), (5, None),
                                              (16, None), (9, 4), (16, 3)])
def test_decode_attention_matches_reference(cache_len, window):
    """GQA (4 query heads on 2 KV heads) over a 16-position cache: the tail
    past cache_len masked, and the window's head."""
    rng = np.random.default_rng(cache_len)
    q = rng.standard_normal((2, 1, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    length = torch.tensor(cache_len, dtype=torch.int32)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), length, window=window)
    want = ref_layers.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.int32(cache_len),
                                       window=window)
    _close(got, want, LAYER_TOL)
    # what lies past cache_len does not matter
    k2, v2 = k.copy(), v.copy()
    k2[:, cache_len:] = 1e3
    v2[:, cache_len:] = -7.0
    again = decode_attention(torch.from_numpy(q), torch.from_numpy(k2),
                             torch.from_numpy(v2), length, window=window)
    assert torch.equal(again, got)


def test_decode_attention_casts_the_softmax_to_the_cache_dtype():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 1, 2, 8)).astype(
        np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((1, 6, 1, 8)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    got = decode_attention(q, k, v, torch.tensor(4, dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    want = ref_layers.decode_attention(
        jnp.asarray(q.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(k.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(v.float().numpy()).astype(jnp.bfloat16), jnp.int32(4))
    _close(got.float(), np.asarray(want, np.float32), 1e-2)


# --------------------------------------------------------------------------
# the MoE FFN
# --------------------------------------------------------------------------
@pytest.mark.parametrize("tokens", [1, 2, 7, 8, 9, 16, 64, 1024])
def test_moe_capacity_matches_reference(tokens):
    for E, K, cf in ((8, 4, 1.25), (128, 8, 1.25), (128, 2, 1.25),
                     (8, 2, 8.0), (16, 1, 0.5)):
        assert moe.moe_capacity(tokens, E, K, cf) == \
            ref_moe.moe_capacity(tokens, E, K, cf)


def _moe_setup(arch, key=0, **overrides):
    """(port cfg, reference cfg, reference layer-0 MoE params, port
    params)."""
    cfg = get_smoke_config(arch).replace(**overrides)
    rcfg = ref_configs.get_smoke_config(arch).replace(**overrides)
    rparams = ref_models.build_model(rcfg).init(jax.random.PRNGKey(key))
    rlp = jax.tree_util.tree_map(lambda a: a[0], rparams["layers"]["moe"])
    lp = tree_from_numpy(jax.tree_util.tree_map(np.asarray, rlp), device=CPU)
    return cfg, rcfg, rlp, lp


def _ref_routing(x, rlp, rcfg, G):
    """The reference's routing (moe.py, its ``moe_ffn`` lines), exposed:
    top experts, slots, and the kept assignments."""
    B, S, D = x.shape
    T = B * S
    Tg = T // G
    C = ref_moe.moe_capacity(Tg, rcfg.num_experts, rcfg.moe_top_k,
                             rcfg.capacity_factor)
    xg = jnp.asarray(x).reshape(G, Tg, D)
    logits = jnp.einsum("gtd,de->gte", xg, rlp["router"]).astype(jnp.float32)
    top_p, top_e = jax.lax.top_k(jax.nn.softmax(logits, -1),
                                 rcfg.moe_top_k)
    onehot = jax.nn.one_hot(top_e.reshape(G, Tg * rcfg.moe_top_k),
                            rcfg.num_experts, dtype=jnp.float32)
    pos = jnp.cumsum(onehot, axis=1) - onehot
    slot = jnp.sum(pos * onehot, -1).astype(jnp.int32).reshape(G, Tg, -1)
    return np.asarray(top_e), np.asarray(slot), np.asarray(slot < C), C


def _port_routing(x, lp, cfg, G):
    B, S, D = x.shape
    Tg = B * S // G
    C = moe.moe_capacity(Tg, cfg.num_experts, cfg.moe_top_k,
                         cfg.capacity_factor)
    xg = torch.from_numpy(x).reshape(G, Tg, D)
    probs = torch.softmax(torch.einsum("gtd,de->gte", xg, lp["router"]), -1)
    _, top_e = moe._top_k(probs, cfg.moe_top_k)
    onehot = torch.nn.functional.one_hot(
        top_e.reshape(G, -1), cfg.num_experts).float()
    pos = torch.cumsum(onehot, 1) - onehot
    slot = (pos * onehot).sum(-1).to(torch.int32).reshape(G, Tg, -1)
    return top_e.numpy(), slot.numpy(), (slot < C).numpy(), C


@pytest.mark.parametrize("arch,groups,shape,cf", [
    ("qwen3_moe_235b", 1, (2, 12), 1.25),
    ("qwen3_moe_235b", 2, (2, 12), 1.25),
    ("qwen3_moe_235b", 16, (2, 9), 1.25),    # T = 18: 16 does not divide
    ("qwen3_moe_235b", 16, (8, 1), 1.25),    # decode-sized: C = Tg
    ("arctic_480b", 2, (3, 8), 1.25),
    ("arctic_480b", 1, (2, 12), 0.5),
    ("qwen3_moe_235b", 1, (2, 8), 8.0)])
def test_moe_ffn_drops_what_the_reference_drops(arch, groups, shape, cf):
    """Tokens drawn around a few shared directions so experts overflow at
    capacity_factor 1.25: the same experts, slots and drops as the
    reference, and its output within 1e-6."""
    cfg, rcfg, rlp, lp = _moe_setup(arch, capacity_factor=cf)
    rng = np.random.default_rng(groups + shape[0])
    base = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    pick = rng.integers(0, 3, shape)
    x = (base[pick] + 0.3 * rng.standard_normal(
        (*shape, cfg.d_model))).astype(np.float32)
    G = moe.moe_groups(shape[0] * shape[1], groups)
    rG = max(1, min(groups, shape[0] * shape[1]))
    while (shape[0] * shape[1]) % rG:
        rG -= 1
    assert G == rG
    ours, ref = _port_routing(x, lp, cfg, G), _ref_routing(x, rlp, rcfg, G)
    assert ours[3] == ref[3]
    for a, b in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    dropped = int((~ref[2]).sum())
    if cf == 1.25 and groups == 1 and arch == "qwen3_moe_235b":
        assert dropped > 0, "the case was meant to drop tokens"
    if cf >= 8.0 or shape[1] == 1:
        assert dropped == 0
    got = moe.moe_ffn(torch.from_numpy(x), lp, cfg, groups)
    want = ref_moe.moe_ffn(jnp.asarray(x), rlp, rcfg, groups)
    _close_rel(got, want, MOE_TOL)


def test_top_k_breaks_ties_toward_the_lower_index():
    """jax.lax.top_k's order under ties, where torch.topk promises none."""
    probs = np.array([[0.1, 0.3, 0.3, 0.1, 0.2, 0.3],
                      [0.25, 0.25, 0.25, 0.25, 0.0, 0.0],
                      [0.0, 0.0, 0.5, 0.0, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3, 4):
        vals, idx = moe._top_k(torch.from_numpy(probs), k)
        rvals, ridx = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "arctic_480b"])
def test_moe_ffn_with_a_zero_router_takes_experts_0_to_k(arch):
    """Every router logit ties: both packages take experts 0..K-1 for every
    token, in that order, with equal weights."""
    cfg, rcfg, rlp, lp = _moe_setup(arch)
    rlp = dict(rlp, router=jnp.zeros_like(rlp["router"]))
    lp = dict(lp, router=torch.zeros_like(lp["router"]))
    x = np.random.default_rng(1).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    top_e, _, keep, _ = _port_routing(x, lp, cfg, 1)
    assert (top_e == np.arange(cfg.moe_top_k)).all()
    rtop_e, _, rkeep, _ = _ref_routing(x, rlp, rcfg, 1)
    np.testing.assert_array_equal(top_e, rtop_e)
    np.testing.assert_array_equal(keep, rkeep)
    _close_rel(moe.moe_ffn(torch.from_numpy(x), lp, cfg, 1),
               ref_moe.moe_ffn(jnp.asarray(x), rlp, rcfg, 1), MOE_TOL)


def test_moe_dispatch_is_dropless_at_capacity():
    """The reference's test on the port: at capacity_factor 8.0 the output
    equals an explicit per-token dense routing through the top-k experts."""
    cfg, _, _, lp = _moe_setup("qwen3_moe_235b", capacity_factor=8.0)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    out = moe.moe_ffn(x, lp, cfg, num_groups=1)
    probs = torch.softmax(torch.einsum("bsd,de->bse", x, lp["router"]), -1)
    top_p, top_e = moe._top_k(probs, cfg.moe_top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    ref = torch.zeros_like(x)
    for b in range(2):
        for s in range(8):
            for j in range(cfg.moe_top_k):
                e = int(top_e[b, s, j])
                g = torch.nn.functional.silu(x[b, s] @ lp["wi_0"][e])
                u = x[b, s] @ lp["wi_1"][e]
                ref[b, s] += top_p[b, s, j] * ((g * u) @ lp["wo"][e])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)


# --------------------------------------------------------------------------
# the models against the reference
# --------------------------------------------------------------------------
def _pair(arch, key=0, **overrides):
    """(port cfg, reference cfg, reference params, port params, numpy
    batch with labels and, for the VLM, prefix_embeds)."""
    cfg = get_smoke_config(arch).replace(**overrides)
    rcfg = ref_configs.get_smoke_config(arch).replace(**overrides)
    rparams = ref_models.build_model(rcfg).init(jax.random.PRNGKey(key))
    params = tree_from_numpy(jax.tree_util.tree_map(np.asarray, rparams),
                             device=CPU)
    rng = np.random.default_rng(len(arch))
    data = {"tokens": rng.integers(0, cfg.vocab_size,
                                   (BATCH, SEQ)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size,
                                   (BATCH, SEQ)).astype(np.int32)}
    data["labels"][0, :3] = -1
    if cfg.family == "vlm":
        data["prefix_embeds"] = rng.standard_normal(
            (BATCH, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    return cfg, rcfg, rparams, params, data


def _torch_batch(data, drop=()):
    return {k: torch.from_numpy(v) for k, v in data.items() if k not in drop}


def _jax_batch(data, drop=()):
    return {k: jnp.asarray(v) for k, v in data.items() if k not in drop}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradient_match_reference(arch):
    cfg, rcfg, rparams, params, data = _pair(arch)
    model, rmodel = build_model(cfg), ref_models.build_model(rcfg)
    prefix = data.get("prefix_embeds")
    with torch.no_grad():
        hidden = transformer.decoder_forward(
            params, torch.from_numpy(data["tokens"]), cfg,
            prefix_embeds=None if prefix is None else torch.from_numpy(prefix))
    _close_rel(hidden, ref_tf.decoder_forward(
        rparams, jnp.asarray(data["tokens"]), rcfg,
        prefix_embeds=None if prefix is None else jnp.asarray(prefix)),
        MODEL_TOL)
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
        _close_rel(node.grad, want, MODEL_TOL, what=str(keypath))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_match_reference(arch):
    cfg, rcfg, rparams, params, data = _pair(arch)
    model, rmodel = build_model(cfg), ref_models.build_model(rcfg)
    max_len = cfg.num_patch_tokens + SEQ + 4
    with torch.no_grad():
        logits, cache = model.prefill(params, _torch_batch(data, ["labels"]),
                                      max_len)
    rlogits, rcache = rmodel.prefill(rparams, _jax_batch(data, ["labels"]),
                                     max_len)
    _close_rel(logits, rlogits, MODEL_TOL)
    assert cache._fields == rcache._fields
    for field in ("k", "v"):
        _close_rel(getattr(cache, field), getattr(rcache, field), MODEL_TOL,
                   what=field)
    assert cache.length.dtype == torch.int32 and cache.length.ndim == 0
    assert int(cache.length) == int(rcache.length) == \
        cfg.num_patch_tokens + SEQ
    for _ in range(3):
        nxt = np.array(jnp.argmax(rlogits, -1)[:, None].astype(jnp.int32))
        before = cache.k.clone()
        with torch.no_grad():
            new_logits, new_cache = model.decode_step(params, cache,
                                                      torch.from_numpy(nxt))
        assert torch.equal(cache.k, before), "the step changed its argument"
        logits, cache = new_logits, new_cache
        rlogits, rcache = rmodel.decode_step(rparams, rcache,
                                             jnp.asarray(nxt))
        _close_rel(logits, rlogits, MODEL_TOL)
        for field in ("k", "v"):
            _close_rel(getattr(cache, field), getattr(rcache, field),
                       MODEL_TOL, what=field)
        assert int(cache.length) == int(rcache.length)


def _prefill_decode_and_longer(model, params, data, cfg, asarray):
    """(prefill(S) + one decode step, prefill(S + 1)) logits as numpy, the
    added token being the first of the prompt; ``asarray`` makes the
    package's arrays from numpy."""
    tok = asarray(np.concatenate([data["tokens"], data["tokens"][:, :1]],
                                 axis=1))
    extra = {k: asarray(v) for k, v in data.items() if k == "prefix_embeds"}
    max_len = cfg.num_patch_tokens + SEQ + 4
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": tok[:, :SEQ], **extra},
                                 max_len)
        a, _ = model.decode_step(params, cache, tok[:, SEQ:])
        b, _ = model.prefill(params, {"tokens": tok, **extra}, max_len)
    return _np(a), _np(b)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_a_longer_prefill(arch):
    """The reference's consistency test on the port (rtol = atol = 2e-3):
    prefill(S) + one decode step against prefill(S + 1). The MoE configs
    at capacity_factor 8.0, where the dispatch is dropless (see the next
    test for 1.25)."""
    over = {"capacity_factor": 8.0} if get_smoke_config(arch).moe else {}
    cfg, _, _, params, data = _pair(arch, **over)
    a, b = _prefill_decode_and_longer(build_model(cfg), params, data, cfg,
                                      torch.from_numpy)
    np.testing.assert_allclose(a, b, rtol=CONSISTENCY_TOL,
                               atol=CONSISTENCY_TOL)


def test_capacity_drops_part_a_longer_prefill_as_in_the_reference():
    """At capacity_factor 1.25 the longer prefill drops late tokens from
    full experts (token-major slots) where the one-token decode step cannot
    drop: prefill + decode and the longer prefill differ far beyond 2e-3,
    in the reference as in the port, by the same logits."""
    cfg, rcfg, rparams, params, data = _pair("qwen3_moe_235b")
    a, b = _prefill_decode_and_longer(build_model(cfg), params, data, cfg,
                                      torch.from_numpy)
    ra, rb = _prefill_decode_and_longer(ref_models.build_model(rcfg),
                                        rparams, data, rcfg, jnp.asarray)
    assert np.abs(rb - ra).max() > 50 * CONSISTENCY_TOL
    _close_rel(a, ra, MODEL_TOL)
    _close_rel(b, rb, MODEL_TOL)


@pytest.mark.parametrize("arch", ["stablelm_12b", "qwen3_moe_235b",
                                  "llava_next_mistral_7b"])
def test_remat_changes_no_value(arch):
    cfg, _, _, params, data = _pair(arch)
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


def test_cache_write_clamps_at_max_len():
    """A decode step at length = max_len writes its K / V at the last
    position, as XLA's dynamic_update_slice clamps the start, and attends
    over every position: the reference's numbers, not an error."""
    cfg, rcfg, rparams, params, data = _pair("stablelm_12b")
    model, rmodel = build_model(cfg), ref_models.build_model(rcfg)
    batch = _torch_batch(data, ["labels"])
    with torch.no_grad():
        _, cache = model.prefill(params, batch, SEQ)
    _, rcache = rmodel.prefill(rparams, _jax_batch(data, ["labels"]), SEQ)
    assert int(cache.length) == SEQ == cache.k.shape[2]
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
    # the positions before the last kept the prompt's K
    with torch.no_grad():
        _, fresh = model.prefill(params, batch, SEQ)
    assert torch.equal(cache.k[:, :, :-1], fresh.k[:, :, :-1])
    assert not torch.equal(cache.k[:, :, -1], fresh.k[:, :, -1])


def test_prefill_longer_than_the_cache_is_refused():
    cfg, _, _, params, data = _pair("stablelm_12b")
    with pytest.raises(ValueError, match="max_len"):
        build_model(cfg).prefill(params, _torch_batch(data, ["labels"]),
                                 SEQ - 1)


def test_layer_windows_alternate_as_the_reference_switch():
    """A per-layer window pattern (the reference's lax.switch over
    layer_windows): forward and a decode step."""
    over = dict(layer_windows=(4, None))
    cfg, rcfg, rparams, params, data = _pair("stablelm_12b", **over)
    with torch.no_grad():
        hidden = transformer.decoder_forward(
            params, torch.from_numpy(data["tokens"]), cfg)
    _close_rel(hidden, ref_tf.decoder_forward(
        rparams, jnp.asarray(data["tokens"]), rcfg), MODEL_TOL)
    model, rmodel = build_model(cfg), ref_models.build_model(rcfg)
    with torch.no_grad():
        _, cache = model.prefill(params, _torch_batch(data, ["labels"]),
                                 SEQ + 2)
        logits, _ = model.decode_step(params, cache,
                                      torch.from_numpy(data["tokens"][:, :1]))
    _, rcache = rmodel.prefill(rparams, _jax_batch(data, ["labels"]),
                               SEQ + 2)
    rlogits, _ = rmodel.decode_step(rparams, rcache,
                                    jnp.asarray(data["tokens"][:, :1]))
    _close_rel(logits, rlogits, MODEL_TOL)


def test_mixed_dtypes_promote_as_the_reference():
    """bf16 activations against float32 weights: the dense MLP and the MoE
    experts promote as JAX does, to the reference's dtype and values (to
    bf16's precision). The reference's layer scan refuses the mix (its
    carry changes dtype); the port's loop runs it, in float32 from the
    first residual add on."""
    for arch in ("arctic_480b", "nemotron4_15b"):
        cfg, rcfg, rparams, params, data = _pair(arch)
        x = np.random.default_rng(5).standard_normal(
            (2, 6, cfg.d_model)).astype(np.float32)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        if cfg.moe:
            lp = transformer._layer(params["layers"], 0)
            rlp = jax.tree_util.tree_map(lambda a: a[0], rparams["layers"])
            pairs = [(moe.moe_ffn(xt, lp["moe"], cfg, 1),
                      ref_moe.moe_ffn(xj, rlp["moe"], rcfg, 1)),
                     (mlp(xt, lp["residual_mlp"], cfg.mlp_act),
                      ref_layers.mlp(xj, rlp["residual_mlp"], rcfg.mlp_act))]
        else:
            lp = transformer._layer(params["layers"], 0)
            rlp = jax.tree_util.tree_map(lambda a: a[0], rparams["layers"])
            pairs = [(mlp(xt, lp["mlp"], cfg.mlp_act),
                      ref_layers.mlp(xj, rlp["mlp"], rcfg.mlp_act))]
        for got, want in pairs:
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
            _close_rel(got.float(), np.asarray(want, np.float32), 2e-2)
        with torch.no_grad():
            out = transformer.decoder_forward(
                params, torch.from_numpy(data["tokens"]),
                cfg.replace(dtype_act=torch.bfloat16))
        assert out.dtype == torch.float32 and torch.isfinite(out).all()


# --------------------------------------------------------------------------
# the registry at the published configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_count_and_active_params_equal_the_reference(arch):
    for get, rget in ((get_config, ref_configs.get_config),
                      (get_smoke_config, ref_configs.get_smoke_config)):
        cfg, rcfg = get(arch), rget(arch)
        assert count_params(cfg) == cfg.param_count == \
            ref_models.count_params(rcfg)
        assert active_params(cfg) == ref_models.active_params(rcfg)
        table = build_model(cfg).param_table
        rtable = ref_models.build_model(rcfg).param_table
        assert table == rtable
    published = {"stablelm_12b": 11_629_122_560,
                 "nemotron4_15b": 14_055_512_064,
                 "phi3_medium_14b": 14_145_704_960,
                 "llava_next_mistral_7b": 7_110_660_096}
    if arch in published:
        assert count_params(get_config(arch)) == published[arch]


@pytest.mark.parametrize("arch", ["llava_next_mistral_7b", "qwen3_moe_235b"])
def test_init_draws_the_table_on_the_generator_device(arch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=CPU).manual_seed(0))
    again = model.init(torch.Generator(device=CPU).manual_seed(0))
    rparams = ref_models.build_model(ref_configs.get_smoke_config(
        arch)).init(jax.random.PRNGKey(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(rparams)[0])
    assert len(_leaves(params)) == len(flat)
    for keypath, want in flat.items():
        node, other = params, again
        for k in keypath:
            node, other = node[k.key], other[k.key]
        assert node.shape == want.shape and node.dtype == torch.float32
        assert torch.equal(node, other)
        assert bool((node == 0).all()) == bool((np.asarray(want) == 0).all())
    cache = model.init_cache(3, 10, device=CPU)
    assert cache.k.shape == (cfg.num_layers, 3, 10, cfg.num_kv_heads,
                             cfg.head_dim)
    assert cache.k.dtype == cfg.dtype_act and int(cache.length) == 0


# --------------------------------------------------------------------------
# the committed fixture (what the card is held against)
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_npz():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def _fixture_arch(ref, arch):
    sub = {k.split("/", 1)[1]: v for k, v in ref.items()
           if k.startswith(arch + "/")}
    params = {k.split("/", 1)[1]: v for k, v in sub.items()
              if k.startswith("params/")}
    return params, {k: v for k, v in sub.items()
                    if not k.startswith("params/")}


@pytest.mark.parametrize("arch", ARCHS)
def test_port_against_the_committed_fixture(reference_npz, arch):
    rparams, r = _fixture_arch(reference_npz, arch)
    params = tree_from_numpy(rparams, device=CPU)
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    data = {k: torch.from_numpy(r[k]) for k in
            ("tokens", "labels", "prefix_embeds") if k in r}
    with torch.no_grad():
        _close_rel(transformer.decoder_forward(
            params, data["tokens"], cfg,
            prefix_embeds=data.get("prefix_embeds")), r["hidden"], MODEL_TOL)
        _close_rel(model.loss(params, data), r["loss"], MODEL_TOL)
        max_len = r["cache_k"].shape[2]
        logits, cache = model.prefill(
            params, {k: v for k, v in data.items() if k != "labels"},
            max_len)
        _close_rel(logits, r["prefill_logits"], MODEL_TOL)
        for field in ("k", "v"):
            _close_rel(getattr(cache, field), r[f"cache_{field}"], MODEL_TOL)
        assert int(cache.length) == int(r["cache_length"])
        for fed, want in zip(r["decode_tokens"], r["decode_logits"]):
            logits, cache = model.decode_step(params, cache,
                                              torch.from_numpy(fed))
            _close_rel(logits, want, MODEL_TOL)


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_reference_decoder", FIXTURE.parent / "make_reference_decoder.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


@pytest.mark.parametrize("arch", ARCHS)
def test_committed_fixture_is_the_reference_output(reference_npz, arch):
    """The parameters the reference draws and its outputs on the stored
    inputs, regenerated through JAX, equal the file's."""
    gen = _generator()
    assert gen.ARCHS == ARCHS
    rparams, r = _fixture_arch(reference_npz, arch)
    cfg = ref_configs.get_smoke_config(arch)
    params = ref_models.build_model(cfg).init(
        jax.random.PRNGKey(gen.SEED + ARCHS.index(arch)))
    for k, v in gen.flatten(params).items():
        np.testing.assert_array_equal(rparams[k], v)
    data = {k: r[k] for k in ("tokens", "labels", "prefix_embeds") if k in r}
    for k, v in gen.outputs(params, cfg, data).items():
        np.testing.assert_allclose(r[k], v, rtol=0, atol=1e-6 * max(
            1.0, float(np.abs(v).max())), err_msg=k)
    assert math.isfinite(float(r["loss"]))
