"""AdamW and Adafactor as plain functions on trees of tensors (counterpart of
``repro.train.optimizers``).

A tree is a nested dict of tensors (the reference's pytree of parameters);
the optimizer state mirrors it. ``torch.optim.AdamW`` is not used, because
a step of the reference differs from it in three ways that this module
keeps: leaves with ``ndim < 2`` (norms, biases) get no weight decay, the
gradients are clipped by their global norm before the step, and the
learning rate is the warmup + cosine schedule evaluated at the step.
Everything is computed in float32 (moments in ``moments_dtype``), as the
reference computes it.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["OptConfig", "cosine_lr", "init_opt_state", "apply_update",
           "apply_update_", "global_norm", "clip_by_global_norm", "tree_map",
           "tree_leaves"]

# Elements of a leaf the in-place update (``apply_update_``) takes at once:
# its float32 temporaries stay near 256 MB each, whatever the leaf's size.
DONATE_CHUNK = 1 << 26


class OptConfig(NamedTuple):
    name: str = "adamw"            # adamw | adafactor
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_dtype: Any = torch.float32
    # adafactor
    factored_min_dim: int = 128


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same nesting), keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the reference's order (dict keys sorted, depth first)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def cosine_lr(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``min_lr_ratio * peak_lr`` at ``decay_steps``; a float32 scalar (on
    ``step``'s device when it is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, decayed)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _is_factored(shape, cfg: OptConfig) -> bool:
    return len(shape) >= 2 and shape[-1] >= cfg.factored_min_dim \
        and shape[-2] >= cfg.factored_min_dim


def init_opt_state(params, cfg: OptConfig) -> dict:
    md = cfg.moments_dtype
    if cfg.name == "adamw":
        def zeros(p):
            return torch.zeros(p.shape, dtype=md, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}
    if cfg.name == "adafactor":
        def vrow(p):
            shape = p.shape[:-1] if _is_factored(p.shape, cfg) else p.shape
            return torch.zeros(shape, dtype=md, device=p.device)

        def vcol(p):
            shape = ((*p.shape[:-2], p.shape[-1])
                     if _is_factored(p.shape, cfg) else (0,))
            return torch.zeros(shape, dtype=md, device=p.device)

        return {"vr": tree_map(vrow, params), "vc": tree_map(vcol, params)}
    raise ValueError(cfg.name)


def _adamw_leaf(p, g, m, v, lr, step, cfg: OptConfig, decay=None):
    """One AdamW step of a leaf; ``decay`` (default: ``p.ndim >= 2``) says
    whether the leaf takes weight decay."""
    g32 = g.float()
    m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
    v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
    mhat = m32 / (1 - torch.pow(cfg.b1, step))
    vhat = v32 / (1 - torch.pow(cfg.b2, step))
    upd = mhat / (torch.sqrt(vhat) + cfg.eps)
    if p.ndim >= 2 if decay is None else decay:  # none on norms / biases
        upd = upd + cfg.weight_decay * p.float()
    newp = p.float() - lr * upd
    return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)


def _adafactor_leaf(p, g, vr, vc, lr, step, cfg: OptConfig):
    g32 = g.float()
    decay = 1.0 - torch.pow(step, -0.8)
    if _is_factored(p.shape, cfg):
        r = decay * vr.float() + (1 - decay) * torch.mean(g32 * g32, dim=-1)
        c = decay * vc.float() + (1 - decay) * torch.mean(g32 * g32, dim=-2)
        rc = r[..., None] * c[..., None, :]
        denom = torch.sqrt(rc / torch.clamp_min(
            torch.mean(r, dim=-1)[..., None, None], 1e-30)) + cfg.eps
        upd = g32 / denom
        new_vr, new_vc = r.to(vr.dtype), c.to(vc.dtype)
    else:
        v = decay * vr.float() + (1 - decay) * g32 * g32
        upd = g32 / (torch.sqrt(v) + cfg.eps)
        new_vr, new_vc = v.to(vr.dtype), vc
    # update clipping (the Adafactor RMS-1 rule)
    rms = torch.sqrt(torch.mean(upd * upd) + 1e-30)
    upd = upd / torch.clamp_min(rms, 1.0)
    if p.ndim >= 2:
        upd = upd + cfg.weight_decay * p.float()
    newp = p.float() - lr * upd
    return newp.to(p.dtype), new_vr, new_vc


def apply_update(params, grads, opt_state: dict, step, cfg: OptConfig):
    """One optimizer step at ``step`` (0-based, a Python int or an integer
    tensor); returns (new_params, new_opt_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = torch.as_tensor(step, device=gnorm.device)
    lr = cosine_lr(cfg, step)
    stepf = step.to(torch.float32) + 1.0
    if cfg.name == "adamw":
        leaf, keys = _adamw_leaf, ("m", "v")
    elif cfg.name == "adafactor":
        leaf, keys = _adafactor_leaf, ("vr", "vc")
    else:
        raise ValueError(cfg.name)
    out = tree_map(lambda p, g, a, b: leaf(p, g, a, b, lr, stepf, cfg),
                   params, grads, opt_state[keys[0]], opt_state[keys[1]])
    newp, new_a, new_b = (_pick(out, i) for i in range(3))
    return newp, {keys[0]: new_a, keys[1]: new_b}, {"lr": lr,
                                                    "grad_norm": gnorm}


def _chunks(x: torch.Tensor):
    """Contiguous flat views of ``x`` of at most ``DONATE_CHUNK`` elements."""
    flat = x.view(-1)
    return [flat[i:i + DONATE_CHUNK]
            for i in range(0, flat.numel(), DONATE_CHUNK)]


def apply_update_(params, grads, opt_state: dict, step, cfg: OptConfig):
    """:func:`apply_update` in place: ``params`` and ``opt_state`` are
    overwritten with the new values (the reference's donated train state)
    and ``grads`` is consumed; returns the metrics.

    AdamW runs over flat chunks of each leaf, so no float32 copy of a whole
    leaf is made; the global norm sums the chunks' squares, so it may differ
    from :func:`global_norm`'s in the last bits. Adafactor's factored
    moments need whole leaves: each leaf is updated at once and copied back.
    """
    grads = tree_map(torch.Tensor.contiguous, grads)
    sq = [torch.sum(torch.square(c.float()))
          for g in tree_leaves(grads) for c in _chunks(g)]
    gnorm = torch.sqrt(sum(sq))
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    step = torch.as_tensor(step, device=gnorm.device)
    lr = cosine_lr(cfg, step)
    stepf = step.to(torch.float32) + 1.0
    keys = {"adamw": ("m", "v"), "adafactor": ("vr", "vc")}.get(cfg.name)
    if keys is None:
        raise ValueError(cfg.name)
    leaves = zip(tree_leaves(params), tree_leaves(grads),
                 tree_leaves(opt_state[keys[0]]),
                 tree_leaves(opt_state[keys[1]]))
    for p, g, a, b in leaves:
        if cfg.name == "adamw":
            parts = zip(_chunks(p), _chunks(g), _chunks(a), _chunks(b))
            for pc, gc, ac, bc in parts:
                gc = (gc.float() * scale).to(gc.dtype)
                new = _adamw_leaf(pc, gc, ac, bc, lr, stepf, cfg,
                                  decay=p.ndim >= 2)
                for old, value in zip((pc, ac, bc), new):
                    old.copy_(value)
        else:
            g = (g.float() * scale).to(g.dtype)
            new = _adafactor_leaf(p, g, a, b, lr, stepf, cfg)
            for old, value in zip((p, a, b), new):
                old.copy_(value)
    return {"lr": lr, "grad_norm": gnorm}


def _pick(tree, i: int):
    """The i-th element of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
