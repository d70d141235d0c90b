"""GPipe pipeline parallelism over a mesh axis, by default 'pod'
(counterpart of ``repro.train.pipeline``).

The layer stack is split into ``S`` contiguous stages, one a rank of the
axis; ``M`` microbatches stream through them in the standard GPipe
fill-drain schedule of ``T = M + S - 1`` ticks (bubble fraction
``(S - 1) / T``). At every tick each stage runs its layers on one input
(stage 0 on a fresh microbatch, the others on what the previous stage sent
at the last tick), keeps the result only when its microbatch is in range,
and hands it to the next stage: a point-to-point exchange over the axis's
process group (the reference's ``ppermute``). The last stage collects the
finished microbatches, and a sum over the axis of the last stage's buffer
(zeros elsewhere) gives every stage the output (the reference's masked
``psum``).

Gradients flow through the schedule as ``jax.grad`` flows through the
reference's ``shard_map``: the exchange's backward is the reverse exchange
(each rank sends its input's gradient back to the previous stage) and the
final sum passes the gradient through. Every tick's input is kept in the
graph on every stage, so every rank runs each exchange's backward in the
same order. A stage's parameters get the gradient of its own layers; the
input's gradient is partial over the axis (stage 0's share only).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed.sharding import mesh_shape, sum_to_replicas
from .optimizers import tree_map

__all__ = ["pipelined_forward"]


def _exchange(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Every rank of ``group`` sends ``x`` to the rank ``step`` further on
    (cyclic) and returns what the rank ``step`` before it sent."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Shift(torch.autograd.Function):
    """The reference's ``ppermute`` to the next stage; its backward sends
    the gradient to the previous one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, -1), None


def _stage_block(a: torch.Tensor, stage: int, stages: int) -> torch.Tensor:
    """This stage's slice of a stacked leaf (leading dimension ``stages``):
    a ``DTensor`` split over the axis gives its block, a plain tensor that
    every rank holds its row."""
    if hasattr(a, "device_mesh"):
        return a.to_local()[0]
    if a.shape[0] != stages:
        raise ValueError(f"a stage leaf leads with {a.shape[0]} stages, the "
                         f"axis has {stages}")
    return a[stage]


def pipelined_forward(mesh, layer_fn, num_microbatches: int,
                      axis: str = "pod"):
    """``fn(stage_params, x)`` running ``layer_fn`` stacks as a pipeline
    over ``axis`` of ``mesh``.

    ``layer_fn(stage_params, x_micro) -> y_micro`` applies ONE stage (its
    share of the layers) to one microbatch and keeps its shape.
    ``stage_params``: a tree whose leaves lead with the stage count, as
    ``DTensor`` s split over ``axis`` on that dimension or as plain tensors
    every rank holds; ``x``: the (M * mb, ...) batch, the same on every
    rank, split into M microbatches. Returns the last stage's output for
    the whole batch on every rank of the axis. An axis of one rank runs the
    microbatches through its one stage, with no communication."""
    sizes = mesh_shape(mesh)
    S = sizes[axis]
    M = num_microbatches
    group = mesh.get_group(axis) if S > 1 else None
    stage = mesh.get_local_rank(axis) if S > 1 else 0

    def fn(stage_params, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % M:
            raise ValueError(f"{M} microbatches do not divide a batch of "
                             f"{x.shape[0]}")
        sp = tree_map(lambda a: _stage_block(a, stage, S), stage_params)
        xs = x.reshape(M, x.shape[0] // M, *x.shape[1:])
        flag = lambda b: torch.tensor(b, device=x.device)  # noqa: E731
        first, last = flag(stage == 0), flag(stage == S - 1)
        buf = torch.zeros_like(xs[0])
        outs = [torch.zeros_like(xs[0]) for _ in range(M)]
        for t in range(M + S - 1):
            mb = t - stage            # the microbatch this stage works on
            active = 0 <= mb < M
            # Stage 0 reads a fresh microbatch, the others the buffer. Both
            # selections keep their operands in the graph on every stage
            # (as the reference's jnp.where), so every rank's backward
            # reaches each exchange and runs it in the same order.
            x_in = torch.where(first, xs[min(max(mb, 0), M - 1)], buf)
            y = torch.where(flag(active), layer_fn(sp, x_in),
                            torch.zeros_like(xs[0]))
            if group is not None:
                buf = _Shift.apply(y, group)
            k = min(max(t - (S - 1), 0), M - 1)
            outs[k] = torch.where(flag(active and stage == S - 1), y,
                                  outs[k])
        out = torch.where(last, torch.stack(outs), 0.0)
        if group is not None:
            out = sum_to_replicas(out, (group,))
        return out.reshape(x.shape)

    return fn
