"""Regenerate tests/fixtures/reference_griffin.npz (committed fixture).

The reference's Griffin hybrid at its smoke config (``repro.configs.
get_smoke_config("recurrentgemma_2b")``: 5 layers rec, rec, attn, rec, rec,
window 8; parameters drawn by the reference at ``PRNGKey(SEED)``), run by
JAX on the CPU on inputs made with numpy from a seed, so the port is held
against it without JAX (``tests/test_torch_griffin.py`` on the CPU,
``chip_smoke.py``'s ``griffin`` phase on the card). It holds:

* ``params/<path>``: the parameter tree, ``/``-joined;
* ``tokens`` and ``labels`` (2, SEQ), SEQ = 12 > window, not a multiple of
  it; the forward's final ``hidden`` states (2, SEQ, D) and the ``loss``;
* the prefill of the first PROMPT = 6 tokens (fewer than the window):
  ``prefill_logits`` (2, V) and every cache field (``cache_h``,
  ``cache_conv``, ``cache_k``, ``cache_v``, ``cache_pos``,
  ``cache_length``);
* three greedy decode steps from it, at positions 6, 7 and 8, the last
  wrapping the window's buffer: ``decode_tokens`` (3, 2, 1) fed,
  ``decode_logits`` (3, 2, V) returned, and the cache after the last step
  (``final_cache_<field>``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_reference_griffin.py
"""
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config
from repro.models import build_model
from repro.models.griffin import griffin_forward

OUT = os.path.join(os.path.dirname(__file__), "reference_griffin.npz")
ARCH = "recurrentgemma_2b"
SEED = 24
BATCH = 2
SEQ = 12
PROMPT = 6
DECODE_STEPS = 3


def flatten(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def inputs(cfg, rng):
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   (BATCH, SEQ)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size,
                                   (BATCH, SEQ)).astype(np.int32)}


def outputs(params, cfg, data):
    """The reference's outputs on ``data``."""
    model = build_model(cfg)
    batch = {k: jnp.asarray(v) for k, v in data.items()}
    out = {"hidden": np.asarray(griffin_forward(params, batch["tokens"],
                                                cfg)),
           "loss": np.asarray(model.loss(params, batch))}
    logits, cache = model.prefill(params,
                                  {"tokens": batch["tokens"][:, :PROMPT]})
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
    for field in cache._fields:
        out[f"final_cache_{field}"] = np.asarray(getattr(cache, field))
    return out


def main():
    cfg = get_smoke_config(ARCH)
    params = build_model(cfg).init(jax.random.PRNGKey(SEED))
    data = inputs(cfg, np.random.default_rng(SEED))
    arrays = {f"params/{k}": v for k, v in flatten(params).items()}
    arrays.update(data)
    arrays.update(outputs(params, cfg, data))
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {len(arrays)} arrays, "
          f"{os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
