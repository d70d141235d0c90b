"""Regenerate tests/fixtures/reference_encdec.npz (committed fixture).

The reference's Whisper encoder-decoder at its smoke config (``repro.
configs.get_smoke_config("whisper_tiny")``: 2 + 2 layers, 24 frames;
parameters drawn by the reference at ``PRNGKey(SEED)``), run by JAX on the
CPU on inputs made with numpy from a seed, so the port is held against it
without JAX (``tests/test_torch_encdec.py`` on the CPU, ``chip_smoke.py``'s
``encdec`` phase on the card). It holds:

* ``params/<path>``: the parameter tree, ``/``-joined, except that
  ``params/dec_pos`` keeps only its first MAX_LEN rows, the only ones these
  outputs read (the table has 32768 rows, 8 MB of float32 at the smoke
  width): :func:`full_params` pads it back with zeros;
* ``frames`` (2, 24, D) float32 standard normal, ``tokens`` and ``labels``
  (2, SEQ); the encoder's output ``encoded``, the decoder's final
  ``hidden`` states (2, SEQ, D) and the ``loss``;
* the prefill's ``prefill_logits`` (2, V) and cache (``cache_k``,
  ``cache_v`` (L, 2, MAX_LEN, H, Dh), ``cache_xk``, ``cache_xv``,
  ``cache_length``) at ``MAX_LEN = SEQ + DECODE_STEPS``;
* three greedy decode steps from it: ``decode_tokens`` (3, 2, 1) fed and
  ``decode_logits`` (3, 2, V) returned.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_reference_encdec.py
"""
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config
from repro.models import build_model
from repro.models.encdec import decode_train, encode

OUT = os.path.join(os.path.dirname(__file__), "reference_encdec.npz")
ARCH = "whisper_tiny"
SEED = 24
BATCH = 2
SEQ = 12
DECODE_STEPS = 3
MAX_LEN = SEQ + DECODE_STEPS


def flatten(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def stored_params(params):
    """The flattened tree as the file stores it (``dec_pos`` cut)."""
    flat = flatten(params)
    flat["dec_pos"] = flat["dec_pos"][:MAX_LEN]
    return flat


def full_params(flat, dec_pos_rows):
    """The stored tree with ``dec_pos`` padded back to ``dec_pos_rows``
    rows with zeros."""
    flat = dict(flat)
    pos = flat["dec_pos"]
    flat["dec_pos"] = np.concatenate(
        [pos, np.zeros((dec_pos_rows - pos.shape[0], pos.shape[1]),
                       pos.dtype)])
    return flat


def inputs(cfg, rng):
    return {"frames": rng.standard_normal(
                (BATCH, cfg.enc_frames, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size,
                                   (BATCH, SEQ)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size,
                                   (BATCH, SEQ)).astype(np.int32)}


def outputs(params, cfg, data):
    """The reference's outputs on ``data``."""
    model = build_model(cfg)
    batch = {k: jnp.asarray(v) for k, v in data.items()}
    enc = encode(params, batch["frames"], cfg)
    out = {"encoded": np.asarray(enc),
           "hidden": np.asarray(decode_train(params, enc, batch["tokens"],
                                             cfg)),
           "loss": np.asarray(model.loss(params, batch))}
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    logits, cache = model.prefill(params, prompt, MAX_LEN)
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
    cfg = get_smoke_config(ARCH)
    params = build_model(cfg).init(jax.random.PRNGKey(SEED))
    data = inputs(cfg, np.random.default_rng(SEED))
    arrays = {f"params/{k}": v for k, v in stored_params(params).items()}
    arrays.update(data)
    arrays.update(outputs(params, cfg, data))
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {len(arrays)} arrays, "
          f"{os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
