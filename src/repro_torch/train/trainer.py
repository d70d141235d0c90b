"""The train step and the serve steps, on one device or a ``DeviceMesh``
(counterpart of ``repro.train.trainer``).

:func:`make_train_step` builds ``step_fn(state, batch) -> (state,
metrics)`` for any model with the zoo's shape (``init(generator, place=)``,
``loss(params, batch, constrain)``): the loss's gradient through autograd,
optionally accumulated over ``grad_accum`` microbatches, then one step of
:func:`repro_torch.train.optimizers.apply_update`. The microbatches are the
reference's *strided* ones: microbatch ``i`` holds rows ``i, i + accum,
i + 2 accum, ...`` of every batch entry (the reference's reshape to
(B / accum, accum, ...) and swap of the first two axes). With
``donate=True`` the step updates the state's tensors in place
(:func:`repro_torch.train.optimizers.apply_update_`), as the reference's
donated train state does; the caller must not use the state it passed in
again.

On a mesh the parameters and moments are ``DTensor`` s laid out by the
logical-axis rules (``distributed/sharding.py``: ``rules_for`` by default,
``state_shardings``), the batch goes over the data-parallel axes, the loss
runs under ``implicit_replication`` with the activation ``constrain`` and
the mesh made active (the MoE's expert-parallel switch), every gradient is
put in its parameter's placements, and the optimizer steps each rank's
blocks. The int8 gradient compression over 'pod' (``train/compression.py``)
and the GPipe schedule (``train/pipeline.py``) are modules of their own, as
in the reference, which does not wire them into the step.
:func:`make_serve_steps` gives a zoo model's prefill and decode step on one
device, or on a ``DeviceMesh`` with the parameters and caches placed by the
logical-axis rules.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .._device import resolve_device
from ..distributed.sharding import (NamedSharding, batch_shardings,
                                    cache_spec, make_constrain,
                                    param_placer, param_shardings, rules_for,
                                    set_active_mesh, shard_tensor,
                                    state_shardings, table_shapes)
from .optimizers import (OptConfig, align_grads, apply_update, apply_update_,
                         init_opt_state, tree_leaves, tree_map)

__all__ = ["TrainState", "TrainSetup", "make_train_step", "make_serve_steps"]


class TrainState(NamedTuple):
    params: Any              # nested dict of tensors
    opt_state: Any           # the optimizer's trees
    step: torch.Tensor       # 0-d int32, steps taken


class TrainSetup(NamedTuple):
    step_fn: Callable        # (state, batch) -> (state, metrics)
    init_state: Callable     # (seed) -> TrainState on the setup's device
    device: torch.device
    state_shardings: Any = None    # TrainState of NamedSharding trees
    batch_shardings: Callable | None = None   # batch -> NamedSharding dict
    grad_fn: Callable | None = None   # (params, batch) -> (loss, grads)


def _value_and_grad(loss_fn, params, batch):
    """Loss and its gradient tree at ``params``, both detached. A
    ``DTensor`` loss is read as its whole value; each ``DTensor`` gradient
    comes back in its parameter's placements."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(live, batch)
        if hasattr(loss, "full_tensor"):
            loss = loss.full_tensor()
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach has a zero gradient, as under jax.grad
    by_id = {id(leaf): torch.zeros_like(leaf) if g is None else g
             for leaf, g in zip(leaves, grads)}
    return loss.detach(), align_grads(tree_map(lambda p: by_id[id(p)], live),
                                      live)


def _local_rows(v: torch.Tensor, i: int, accum: int) -> torch.Tensor:
    """Rows ``i::accum`` of a batch entry; of a ``DTensor``, of each rank's
    block, which together are the reference's strided microbatch ``i``
    when every rank's block divides by ``accum``."""
    if not hasattr(v, "device_mesh"):
        return v[i::accum]
    from torch.distributed.tensor import DTensor

    local = v.to_local()[i::accum]
    shape = (v.shape[0] // accum, *v.shape[1:])
    return DTensor.from_local(local, v.device_mesh, v.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=local.stride())


def make_train_step(model, opt_cfg: OptConfig | None = None,
                    grad_accum: int = 1, device=None,
                    donate: bool = False, mesh=None, rules=None,
                    act_rules=None) -> TrainSetup:
    """The train step of ``model`` on ``device`` (``None``: the GPU), or on
    ``mesh`` (a ``DeviceMesh`` over the process group, each rank on its
    ``device``).

    ``init_state(seed)`` draws the parameters from the keyed stream of
    ``seed`` (``build_params``) on the device; on a mesh each rank draws
    only its blocks (``sharding.param_placer``: the same values as on one
    device, never a whole leaf) and the moments are made as each rank's
    blocks. ``step_fn``
    takes a dict of tensors on that device (on a mesh: plain tensors every
    rank holds alike, or ``DTensor`` s); with ``grad_accum > 1`` every
    entry's leading axis (on a mesh: each rank's block of it) must be
    divisible by it, and the loss and gradient are the means over the
    microbatches. ``metrics`` holds device scalars (``loss``, ``lr``,
    ``grad_norm``; plain tensors on a mesh too): nothing in a step reads
    the device. ``grad_fn(params, batch)`` is the loss and gradient tree the
    step takes (the gradients in the parameters' placements).

    On a mesh ``rules`` (default ``rules_for(model.cfg)``: FSDP from 1e10
    parameters, else tensor parallel) lay out the state and ``act_rules``
    (default ``ACT_RULES``) the activations; ``state_shardings`` and
    ``batch_shardings(batch)`` are the reference's layouts.

    ``donate`` defaults to False, where the reference's defaults to True:
    JAX refuses a donated buffer's later use, PyTorch would read the new
    values silently, so the in-place step is asked for by name. It holds
    the parameters, gradients and moments once, where the functional step
    holds a new copy of each beside the old; on a mesh it updates each
    rank's blocks in place.
    """
    opt_cfg = opt_cfg or OptConfig()
    dev = resolve_device(device)
    constrain = None
    st_sh = place_batch = None
    if mesh is not None:
        rules = rules if rules is not None else rules_for(model.cfg)
        constrain = make_constrain(mesh, act_rules)
        st_sh = state_shardings(model, mesh, rules, opt_cfg)

        def place_batch(batch: dict) -> dict:
            return _place_batch(batch, mesh, dev)

    def loss_fn(params, batch):
        if mesh is None:
            return model.loss(params, batch)
        return model.loss(params, batch, constrain=constrain)

    def grad_fn(params, batch: dict):
        set_active_mesh(mesh)
        if mesh is None:
            return _value_and_grad(loss_fn, params, batch)
        from torch.distributed.tensor.experimental import \
            implicit_replication
        batch = place_batch(batch)
        with implicit_replication():
            return _value_and_grad(loss_fn, params, batch)

    def accumulate(params, batch: dict):
        if grad_accum == 1:
            return grad_fn(params, batch)
        if mesh is not None:
            batch = place_batch(batch)
            for k, v in batch.items():
                rows = v.to_local().shape[0]
                if rows % grad_accum:
                    raise ValueError(
                        f"grad_accum={grad_accum} must divide each rank's "
                        f"rows of the batch; {k!r} has {rows} of "
                        f"{v.shape[0]} on this rank")
        gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
        lsum = 0.0
        for i in range(grad_accum):
            mb = {k: _local_rows(v, i, grad_accum) for k, v in batch.items()}
            loss, g = grad_fn(params, mb)
            gsum = tree_map(lambda a, b: a + b.float(), gsum, g)
            lsum = lsum + loss
        return lsum / grad_accum, tree_map(lambda g: g / grad_accum, gsum)

    def train_step(state: TrainState, batch: dict):
        loss, grads = accumulate(state.params, batch)
        if donate:
            with torch.no_grad():
                metrics = apply_update_(state.params, grads, state.opt_state,
                                        state.step, opt_cfg)
            new_params, new_opt = state.params, state.opt_state
        else:
            with torch.no_grad():
                new_params, new_opt, metrics = apply_update(
                    state.params, grads, state.opt_state, state.step,
                    opt_cfg)
        metrics["loss"] = loss
        return TrainState(params=new_params, opt_state=new_opt,
                          step=state.step + 1), metrics

    def init_state(seed: int) -> TrainState:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        if mesh is None:
            params = model.init(gen)
            opt = init_opt_state(params, opt_cfg)
        else:
            params = model.init(gen, place=param_placer(
                model.param_table, mesh, rules))
            opt = init_opt_state(params, opt_cfg, st_sh.opt_state)
        return TrainState(params=params, opt_state=opt,
                          step=torch.zeros((), dtype=torch.int32, device=dev))

    return TrainSetup(
        step_fn=train_step, init_state=init_state, device=dev,
        state_shardings=st_sh,
        batch_shardings=None if mesh is None
        else (lambda batch: batch_shardings(batch, mesh)),
        grad_fn=grad_fn)


def make_serve_steps(model, max_len: int = 2048, device=None, mesh=None,
                     rules=None) -> dict:
    """The prefill and decode step of a zoo ``model`` on one device
    (``None``: the GPU), or on ``mesh``.

    ``prefill(params, batch) -> (logits, cache)`` and ``decode_step(params,
    cache, tokens) -> (logits, cache)`` move their token inputs to the
    device and run without autograd; the parameters must already live
    there. A decode step returns a new cache and leaves its argument as it
    was (the reference donates its cache instead).

    With a ``DeviceMesh`` (:func:`repro_torch.launch.mesh.make_debug_mesh`)
    the dict also holds the reference's ``param_shardings`` (a
    :class:`~repro_torch.distributed.sharding.NamedSharding` tree by
    ``rules``, default ``SERVE_RULES``), ``cache_shardings(batch, prefer)``
    and ``constrain``, and the steps take parameters placed by
    ``param_shardings`` (``sharding.shard_params``) and plain or placed
    inputs: the batch goes over the data-parallel axes, the model runs on
    ``DTensor`` s under ``implicit_replication`` (the plain tensors it makes
    itself, positions and masks, count as replicated), and both steps return
    the cache in the ``cache_shardings(batch, "width")`` layout the prefill
    emits. The logits are ``DTensor`` s. Each step makes its mesh the active
    one (``sharding.set_active_mesh``: the MoE's expert-parallel switch),
    and a one-device step clears it.
    """
    dev = resolve_device(device)
    if mesh is not None:
        return _mesh_serve_steps(model, max_len, dev, mesh, rules)

    @torch.no_grad()
    def prefill(params, batch: dict):
        set_active_mesh(None)
        batch = {k: v.to(dev) for k, v in batch.items()}
        return model.prefill(params, batch, max_len)

    @torch.no_grad()
    def decode_step(params, cache, tokens: torch.Tensor):
        set_active_mesh(None)
        return model.decode_step(params, cache, tokens.to(dev))

    return {"prefill": prefill, "decode_step": decode_step, "device": dev}


def _place(t, sharding: NamedSharding):
    """``t`` laid out by ``sharding``: a ``DTensor`` redistributed, a plain
    tensor (the same on every rank) cut to this rank's block."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return t.redistribute(sharding.mesh, sharding.placements)
    return shard_tensor(t, sharding.mesh, sharding.spec)


def _place_batch(batch: dict, mesh, dev) -> dict:
    """Every batch entry over the data-parallel axes (``batch_shardings``):
    a plain tensor, the same on every rank, moved to ``dev`` and cut."""
    batch = {k: v if hasattr(v, "device_mesh") else v.to(dev)
             for k, v in batch.items()}
    sh = batch_shardings(batch, mesh)
    return {k: _place(v, sh[k]) for k, v in batch.items()}


def _mesh_serve_steps(model, max_len: int, dev, mesh, rules) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication

    from ..distributed.sharding import SERVE_RULES

    rules = rules if rules is not None else SERVE_RULES
    constrain = make_constrain(mesh)
    p_sh = param_shardings(model.logical, mesh, rules,
                           table_shapes(model.param_table))

    layouts: dict = {}

    def cache_shardings(batch: int, prefer: str = "time"):
        """prefer="time": the T axis over 'model' (decode's steady state);
        "width": the layout the prefill emits (heads / width over
        'model'). Worked out once per (batch, prefer)."""
        if (batch, prefer) not in layouts:
            shapes = model.init_cache(batch, max_len, device="meta")
            layouts[batch, prefer] = type(shapes)(*(NamedSharding(
                mesh, cache_spec(leaf.shape, leaf.dtype, mesh, prefer))
                for leaf in shapes))
        return layouts[batch, prefer]

    def place_cache(cache):
        layout = cache_shardings(cache[0].shape[1], "width")
        return type(cache)(*(_place(leaf, sh) if leaf.ndim >= 2
                             else leaf for leaf, sh in zip(cache, layout)))

    def place_batch(batch: dict) -> dict:
        return _place_batch(batch, mesh, dev)

    @torch.no_grad()
    def prefill(params, batch: dict):
        set_active_mesh(mesh)
        with implicit_replication():
            logits, cache = model.prefill(params, place_batch(batch), max_len,
                                          constrain=constrain)
            return logits, place_cache(cache)

    @torch.no_grad()
    def decode_step(params, cache, tokens: torch.Tensor):
        set_active_mesh(mesh)
        with implicit_replication():
            tokens = place_batch({"tokens": tokens})["tokens"]
            logits, cache = model.decode_step(params, cache, tokens,
                                              constrain=constrain)
            return logits, place_cache(cache)

    return {"param_shardings": p_sh, "cache_shardings": cache_shardings,
            "prefill": prefill, "decode_step": decode_step,
            "constrain": constrain, "device": dev}
