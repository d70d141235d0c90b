"""Regenerate tests/fixtures/reference_decoder.npz (committed fixture).

The reference's decoder family at its seven smoke configs (``repro.configs.
get_smoke_config(arch)`` for the dense, VLM and MoE archs; parameters drawn
by the reference at ``PRNGKey(SEED)``), run by JAX on the CPU on inputs made
with numpy from a seed, so the port is held against it without JAX
(``tests/test_torch_decoder.py`` on the CPU, ``chip_smoke.py``'s ``decoder``
phase on the card). Under ``<arch>/``:

* ``params/<path>``: the parameter tree, ``/``-joined;
* ``tokens`` and ``labels`` (2, S) and, for the VLM, ``prefix_embeds``
  (2, P, D) float32;
* the forward's final ``hidden`` states (2, P + S, D) and the ``loss``;
* the prefill's ``prefill_logits`` (2, V) and cache (``cache_k``,
  ``cache_v`` (L, 2, max_len, Hkv, Dh), ``cache_length``) at
  ``max_len = P + S + DECODE_STEPS``;
* three greedy decode steps from it: ``decode_tokens`` (3, 2, 1) fed and
  ``decode_logits`` (3, 2, V) returned.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_reference_decoder.py
"""
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config
from repro.models import build_model
from repro.models.transformer import decoder_forward

OUT = os.path.join(os.path.dirname(__file__), "reference_decoder.npz")
SEED = 23
BATCH = 2
SEQ = 12
DECODE_STEPS = 3
ARCHS = ("stablelm_12b", "nemotron4_15b", "phi3_medium_14b", "qwen2_72b",
         "llava_next_mistral_7b", "qwen3_moe_235b", "arctic_480b")


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
    """tokens, labels and (VLM) prefix_embeds as numpy arrays."""
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (BATCH, SEQ)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size,
                                  (BATCH, SEQ)).astype(np.int32)}
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.standard_normal(
            (BATCH, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    return out


def outputs(params, cfg, data):
    """The reference's outputs on ``data`` (what the fixture stores beside
    the inputs)."""
    model = build_model(cfg)
    batch = {k: jnp.asarray(v) for k, v in data.items()}
    prefix = batch.get("prefix_embeds")
    out = {"hidden": np.asarray(decoder_forward(
               params, batch["tokens"], cfg, prefix_embeds=prefix)),
           "loss": np.asarray(model.loss(params, batch))}
    max_len = cfg.num_patch_tokens + SEQ + DECODE_STEPS
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    logits, cache = model.prefill(params, prompt, max_len)
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
    arrays = {}
    rng = np.random.default_rng(SEED)
    for i, arch in enumerate(ARCHS):
        cfg = get_smoke_config(arch)
        params = build_model(cfg).init(jax.random.PRNGKey(SEED + i))
        data = inputs(cfg, rng)
        for k, v in flatten(params).items():
            arrays[f"{arch}/params/{k}"] = v
        for k, v in {**data, **outputs(params, cfg, data)}.items():
            arrays[f"{arch}/{k}"] = v
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {len(arrays)} arrays, "
          f"{os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
