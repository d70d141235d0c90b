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


def _split(t) -> dict:
    """Tensor dimension -> the process groups of the mesh dimensions that
    split it, for a ``DTensor`` (a dimension of one rank splits nothing);
    ``{}`` for a plain tensor."""
    placements = getattr(t, "placements", None)
    if placements is None:
        return {}
    mesh = t.device_mesh
    out: dict = {}
    for i, p in enumerate(placements):
        if p.is_shard() and mesh.size(i) > 1:
            out.setdefault(p.dim, []).append(mesh.get_group(i))
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of a ``DTensor`` (its storage, outside autograd);
    a plain tensor itself."""
    if not hasattr(t, "device_mesh"):
        return t
    with torch.no_grad():
        return t.to_local()


def _wrap(local: torch.Tensor, like) -> torch.Tensor:
    """``local`` as the block of a ``DTensor`` laid out as ``like`` (of
    ``shape``, default ``like``'s); a plain ``local`` when ``like`` is
    plain."""
    if not hasattr(like, "device_mesh"):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def _placed_as(t: torch.Tensor, placements) -> torch.Tensor:
    """A ``DTensor`` redistributed to ``placements`` (a pending sum is
    reduced: reduce-scatter onto a shard, all-reduce onto a replica)."""
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def align_grads(grads, params):
    """Each ``DTensor`` gradient in its parameter's placements (autograd may
    return a ``Partial`` sum, or another layout); plain leaves pass."""
    return tree_map(lambda g, p: _placed_as(g, p.placements)
                    if hasattr(p, "device_mesh") else g, grads, params)


def _all_reduce(x: torch.Tensor, groups, op=None) -> torch.Tensor:
    for group in groups:
        torch.distributed.all_reduce(
            x, op=op or torch.distributed.ReduceOp.SUM, group=group)
    return x


def _summed_over_shards(values: list, leaves: list) -> list:
    """Each 0-d ``values[i]``, this rank's share of a sum over the elements
    of ``leaves[i]``, summed over the mesh dimensions that split that leaf:
    every element counts once, a replicated leaf's once, not once a rank.
    One all-reduce per group of leaves split alike."""
    by: dict = {}
    for i, leaf in enumerate(leaves):
        groups = [g for gs in _split(leaf).values() for g in gs]
        if groups:
            by.setdefault(tuple(groups), []).append(i)
    values = list(values)
    for groups, idx in by.items():
        total = _all_reduce(torch.stack([values[i] for i in idx]), groups)
        for j, i in enumerate(idx):
            values[i] = total[j]
    return values


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every element of the tree: a ``DTensor`` leaf (in
    ``Shard`` / ``Replicate`` placements) counts each element once, its
    blocks' squares summed over the mesh dimensions that split it."""
    leaves = tree_leaves(tree)
    sq = _summed_over_shards([torch.sum(torch.square(_local(leaf).float()))
                              for leaf in leaves], leaves)
    return torch.sqrt(sum(sq))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda g: _wrap((_local(g).float() * scale).to(g.dtype),
                                    g), tree), norm


def _is_factored(shape, cfg: OptConfig) -> bool:
    return len(shape) >= 2 and shape[-1] >= cfg.factored_min_dim \
        and shape[-2] >= cfg.factored_min_dim


def init_opt_state(params, cfg: OptConfig, shardings=None) -> dict:
    """Zero moments for ``params``; with ``shardings`` (the
    :class:`~repro_torch.distributed.sharding.NamedSharding` tree of the
    moments, ``state_shardings(...).opt_state``) each is made as its block
    on this rank."""
    md = cfg.moments_dtype
    if shardings is not None:
        from ..distributed.sharding import placed_zeros
        shapes = init_opt_state(tree_map(
            lambda p: torch.empty(p.shape, device="meta"), params), cfg)
        device = tree_leaves(params)[0].device
        if hasattr(tree_leaves(params)[0], "device_mesh"):
            device = tree_leaves(params)[0].to_local().device
        return tree_map(lambda s, sh: placed_zeros(s.shape, md, sh, device),
                        shapes, shardings)
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


def _mean(x: torch.Tensor, dim: int, groups, n: int) -> torch.Tensor:
    """``torch.mean`` over ``dim`` of a block whose dimension is split
    over ``groups`` (``n`` elements in all); with no groups, the mean."""
    if not groups:
        return torch.mean(x, dim=dim)
    return _all_reduce(torch.sum(x, dim=dim), groups) / n


def _adafactor_leaf(p, g, vr, vc, lr, step, cfg: OptConfig, shape=None,
                    split=None):
    """One Adafactor step of a leaf of ``shape`` (default: ``p``'s): on a
    mesh, ``p``, ``g`` and the moments are this rank's blocks, aligned (see
    :func:`_moment_placements`), and ``split`` (:func:`_split`) names the
    groups each mean over a split dimension sums over."""
    shape = tuple(p.shape if shape is None else shape)
    split = split or {}
    nd = len(shape)
    g32 = g.float()
    decay = 1.0 - torch.pow(step, -0.8)
    if _is_factored(shape, cfg):
        last, second = split.get(nd - 1, []), split.get(nd - 2, [])
        r = decay * vr.float() + (1 - decay) * _mean(g32 * g32, -1, last,
                                                     shape[-1])
        c = decay * vc.float() + (1 - decay) * _mean(g32 * g32, -2, second,
                                                     shape[-2])
        rc = r[..., None] * c[..., None, :]
        denom = torch.sqrt(rc / torch.clamp_min(
            _mean(r, -1, second, shape[-2])[..., None, None], 1e-30)) \
            + cfg.eps
        upd = g32 / denom
        new_vr, new_vc = r.to(vr.dtype), c.to(vc.dtype)
    else:
        v = decay * vr.float() + (1 - decay) * g32 * g32
        upd = g32 / (torch.sqrt(v) + cfg.eps)
        new_vr, new_vc = v.to(vr.dtype), vc
    # update clipping (the Adafactor RMS-1 rule)
    groups = [gr for gs in split.values() for gr in gs]
    if groups:
        ms = _all_reduce(torch.sum(upd * upd), groups) / math.prod(shape)
    else:
        ms = torch.mean(upd * upd)
    rms = torch.sqrt(ms + 1e-30)
    upd = upd / torch.clamp_min(rms, 1.0)
    if p.ndim >= 2:
        upd = upd + cfg.weight_decay * p.float()
    newp = p.float() - lr * upd
    return newp.to(p.dtype), new_vr, new_vc


def _moment_placements(p, cfg: OptConfig, a, b) -> tuple:
    """The placements of the moments ``a``, ``b`` that line their blocks up
    with ``p``'s: AdamW's and an unfactored second moment are ``p``'s; a
    factored row moment (``p`` without its last dimension) is ``p``'s with
    that dimension's splits replicated, the column moment (``p`` without its
    second-last) likewise. An unused column moment keeps its own."""
    from torch.distributed.tensor import Replicate, Shard

    pl = tuple(p.placements)
    if cfg.name == "adamw":
        return pl, pl
    if not _is_factored(p.shape, cfg):
        return pl, tuple(b.placements)
    nd = p.ndim

    def drop(d):
        return tuple(Replicate() if q.is_shard() and q.dim == d
                     else Shard(q.dim - 1) if q.is_shard() and q.dim > d
                     else q for q in pl)
    return drop(nd - 1), drop(nd - 2)


_LEAF = {"adamw": (lambda p, g, a, b, lr, stepf, cfg, shape, split:
                   _adamw_leaf(p, g, a, b, lr, stepf, cfg,
                               decay=len(shape) >= 2)),
         "adafactor": _adafactor_leaf}
_KEYS = {"adamw": ("m", "v"), "adafactor": ("vr", "vc")}


def _step_leaf(p, g, a, b, lr, stepf, cfg: OptConfig):
    """One step of a leaf and its two moments: on one device the leaf
    function itself; for ``DTensor`` s the leaf function on this rank's
    blocks, the moments redistributed to line up with ``p`` and back."""
    if not hasattr(p, "device_mesh"):
        return _LEAF[cfg.name](p, g, a, b, lr, stepf, cfg, p.shape, {})
    la, lb = _moment_placements(p, cfg, a, b)
    a_al, b_al = _placed_as(a, la), _placed_as(b, lb)
    new_p, new_a, new_b = _LEAF[cfg.name](
        _local(p), _local(_placed_as(g, p.placements)), _local(a_al),
        _local(b_al), lr, stepf, cfg, p.shape, _split(p))
    return (_wrap(new_p, p), _placed_as(_wrap(new_a, a_al), a.placements),
            _placed_as(_wrap(new_b, b_al), b.placements))


def apply_update(params, grads, opt_state: dict, step, cfg: OptConfig):
    """One optimizer step at ``step`` (0-based, a Python int or an integer
    tensor); returns (new_params, new_opt_state, metrics). ``DTensor``
    leaves are stepped on this rank's blocks (their gradients first put in
    their parameters' placements)."""
    keys = _KEYS.get(cfg.name)
    if keys is None:
        raise ValueError(cfg.name)
    grads, gnorm = clip_by_global_norm(align_grads(grads, params),
                                       cfg.clip_norm)
    step = torch.as_tensor(step, device=gnorm.device)
    lr = cosine_lr(cfg, step)
    stepf = step.to(torch.float32) + 1.0
    out = tree_map(lambda p, g, a, b: _step_leaf(p, g, a, b, lr, stepf, cfg),
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
    A ``DTensor`` leaf is updated in its block on this rank (the norm's
    squares summed over the mesh dimensions that split it).
    """
    keys = _KEYS.get(cfg.name)
    if keys is None:
        raise ValueError(cfg.name)
    grads = tree_map(torch.Tensor.contiguous, align_grads(grads, params))
    g_leaves = tree_leaves(grads)
    parts = [(c, g) for g in g_leaves for c in _chunks(_local(g))]
    sq = _summed_over_shards([torch.sum(torch.square(c.float()))
                              for c, _ in parts], [g for _, g in parts])
    gnorm = torch.sqrt(sum(sq))
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    step = torch.as_tensor(step, device=gnorm.device)
    lr = cosine_lr(cfg, step)
    stepf = step.to(torch.float32) + 1.0
    leaves = zip(tree_leaves(params), g_leaves,
                 tree_leaves(opt_state[keys[0]]),
                 tree_leaves(opt_state[keys[1]]))
    for p, g, a, b in leaves:
        if cfg.name == "adamw":
            parts = zip(_chunks(_local(p)), _chunks(_local(g)),
                        _chunks(_local(a)), _chunks(_local(b)))
            for pc, gc, ac, bc in parts:
                gc = (gc.float() * scale).to(gc.dtype)
                new = _adamw_leaf(pc, gc, ac, bc, lr, stepf, cfg,
                                  decay=p.ndim >= 2)
                for old, value in zip((pc, ac, bc), new):
                    old.copy_(value)
        else:
            gl = _local(g)
            g = _wrap((gl.float() * scale).to(gl.dtype), g)
            new = _step_leaf(p, g, a, b, lr, stepf, cfg)
            for old, value in zip((p, a, b), new):
                _local(old).copy_(_local(value))
    return {"lr": lr, "grad_norm": gnorm}


def _pick(tree, i: int):
    """The i-th element of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
