"""Gradient compression for the all-reduce over 'pod': int8 + error feedback
(counterpart of ``repro.train.compression``).

Across pods the gradient all-reduce is the scarcest bandwidth of a
multi-node run. Each leaf is quantised to int8 with a per-leaf scale before
the sum over 'pod', and the quantisation residual stays on the rank ("error
feedback", Seide et al. 2014) to be added to the next step's gradient:
convergence is kept while the bytes that cross pods are a quarter of
float32's.

The sum runs over the 'pod' axis's process group (``DeviceMesh.get_group``):
the int8 payloads summed in int32, the scales reduced by their max, the
sum rescaled by that max and divided by the pod count. Inside a pod the
gradient is already reduced over 'data' by the step. A 'pod' of one rank
runs no collective. As in the reference, the train step does not call it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed.sharding import mesh_shape
from .optimizers import tree_map

__all__ = ["quantize_leaf", "dequantize_leaf", "compressed_psum_tree",
           "make_compressed_allreduce"]


def quantize_leaf(g: torch.Tensor, error: torch.Tensor):
    """int8 symmetric quantisation with carried error feedback: ``(q,
    scale, new_error)``, ``q`` int8, ``scale`` a float32 0-d tensor (at
    least 1e-30), ``g + error = q * scale + new_error`` in float32.
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    g32 = g.float() + error
    scale = torch.amax(torch.abs(g32)) / 127.0
    scale = torch.clamp_min(scale, 1e-30)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_error = g32 - q.float() * scale
    return q, scale, new_error


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_tree(grads, errors, group):
    """Quantise, sum over ``group`` (int32), dequantise, leaf by leaf, with
    error feedback: ``(mean gradients in float32, new errors)``, both trees
    of ``grads``' nesting. ``group=None`` is a group of one rank."""
    n = 1 if group is None else dist.get_world_size(group)

    def leaf(g, e):
        q, scale, new_e = quantize_leaf(g, e)
        # the int8 payloads summed in int32: no overflow up to 2^24 pods
        q_sum = q.to(torch.int32)
        s_max = scale.clone()
        if group is not None:
            dist.all_reduce(q_sum, group=group)
            dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
        return q_sum.float() * s_max / n, new_e

    out = tree_map(leaf, grads, errors)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def make_compressed_allreduce(mesh):
    """``fn(grads, errors) -> (grads, errors)``: the compressed all-reduce
    over the 'pod' axis of ``mesh``, whose ranks hold their pod's gradient
    (plain tensors, the same on every rank of the pod). Refuses a mesh
    without 'pod'."""
    sizes = mesh_shape(mesh)
    if "pod" not in sizes:
        raise ValueError("compressed all-reduce needs a 'pod' mesh axis")
    group = mesh.get_group("pod") if sizes["pod"] > 1 else None

    def fn(grads, errors):
        return compressed_psum_tree(grads, errors, group)

    return fn
