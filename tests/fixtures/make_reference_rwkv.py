"""Regenerate tests/fixtures/reference_rwkv.npz (committed fixture).

The reference's RWKV-6 smoke model (``repro.configs.get_smoke_config(
"rwkv6_1b6")``, parameters drawn by the reference at ``PRNGKey(SEED)``), run
by JAX on the CPU on tokens made with numpy from a seed, so the port is held
against it without JAX (``tests/test_torch_zoo.py`` on the CPU,
``chip_smoke.py``'s ``zoo`` phase on the card):

* ``params/<path>``: the parameter tree, ``/``-joined;
* per WKV path (``scan``: S=12, ``rwkv_chunk`` 0; ``chunk``: S=32,
  ``rwkv_chunk`` 16), under ``<path>/``: ``tokens`` and ``labels`` (2, S),
  the forward ``logits`` (2, S, V) (final hidden states through the head),
  the ``loss``, the prefill's ``prefill_logits`` (2, V) and cache
  (``cache_state``, ``cache_x_tm``, ``cache_x_cm``, ``cache_length``), and
  two greedy decode steps from it (``decode_tokens`` (2, 2, 1) fed,
  ``decode_logits`` (2, 2, V) returned).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_reference_rwkv.py
"""
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config
from repro.models import build_model
from repro.models.rwkv import rwkv_forward

OUT = os.path.join(os.path.dirname(__file__), "reference_rwkv.npz")
SEED = 22
BATCH = 2
PATHS = {"scan": dict(seq=12, rwkv_chunk=0),
         "chunk": dict(seq=32, rwkv_chunk=16)}
DECODE_STEPS = 2


def flatten(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def path_outputs(params, cfg, seq, rng):
    model = build_model(cfg)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (BATCH, seq)).astype(np.int32)
    tok, lab = jnp.asarray(tokens), jnp.asarray(labels)
    hidden = rwkv_forward(params, tok, cfg)
    out = {"tokens": tokens, "labels": labels,
           "logits": np.asarray(jnp.einsum("bsd,dv->bsv", hidden,
                                           params["head"])),
           "loss": np.asarray(model.loss(params, {"tokens": tok,
                                                  "labels": lab}))}
    logits, cache = model.prefill(params, {"tokens": tok})
    out["prefill_logits"] = np.asarray(logits)
    for field in cache._fields:
        out[f"cache_{field}"] = np.asarray(getattr(cache, field))
    fed, got = [], []
    for _ in range(DECODE_STEPS):
        nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        logits, cache = model.decode_step(params, cache, nxt)
        fed.append(np.asarray(nxt))
        got.append(np.asarray(logits))
    out["decode_tokens"] = np.stack(fed)
    out["decode_logits"] = np.stack(got)
    return out


def main():
    base = get_smoke_config("rwkv6_1b6")
    params = build_model(base).init(jax.random.PRNGKey(SEED))
    arrays = {f"params/{k}": v for k, v in flatten(params).items()}
    rng = np.random.default_rng(SEED)
    for name, spec in PATHS.items():
        cfg = base.replace(rwkv_chunk=spec["rwkv_chunk"])
        for k, v in path_outputs(params, cfg, spec["seq"], rng).items():
            arrays[f"{name}/{k}"] = v
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {len(arrays)} arrays, "
          f"{os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
