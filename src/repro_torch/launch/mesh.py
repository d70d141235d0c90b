"""Device meshes over the initialised process group (counterpart of
``repro.launch.mesh``).

The reference's axes, on cards: a single node is ``("data", "model")`` =
(world / 8, 8) with ``model`` inside one 8-card NVLink node (where the
tensor-parallel sums of every layer run), and the multi-node mesh is
``("pod", "data", "model")`` = (2, world / 16, 8), ``pod`` an outer
data-parallel axis. The process group must be initialised first
(``torch.distributed.init_process_group``: NCCL on cards, gloo on the CPU);
the mesh's device type follows its backend. Functions, so importing this
module touches no device and no group.
"""
from __future__ import annotations

import math

import torch.distributed as dist

__all__ = ["make_production_mesh", "make_debug_mesh", "make_mesh_from_args"]

NODE_CARDS = 8          # cards joined by NVLink in one node: the model axis


def _make_mesh(shape: tuple, axes: tuple, device_type: str | None = None):
    """A ``DeviceMesh`` over the whole group: ``cuda`` under NCCL, ``cpu``
    under gloo, or ``device_type`` where given (a fake group's, in the dry
    run)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a device mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """(world / 8, 8) over ("data", "model"), or with ``multi_pod`` (2,
    world / 16, 8) over ("pod", "data", "model"). A world these shapes do
    not fit raises, naming the ranks it needs."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    step = 2 * NODE_CARDS if multi_pod else NODE_CARDS
    if world < step or world % step:
        what = "2 pods of 8-card nodes" if multi_pod else "8-card nodes"
        raise ValueError(f"a production mesh over {what} needs a multiple "
                         f"of {step} ranks; the group has {world}")
    if multi_pod:
        return _make_mesh((2, world // step, NODE_CARDS),
                          ("pod", "data", "model"), device_type)
    return _make_mesh((world // NODE_CARDS, NODE_CARDS), ("data", "model"),
                      device_type)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int | None = None,
                    device_type: str | None = None):
    """A small mesh with the reference's axis names over the whole group."""
    if pod is None:
        return _make_mesh((data, model), ("data", "model"), device_type)
    return _make_mesh((pod, data, model), ("pod", "data", "model"),
                      device_type)


def make_mesh_from_args(args):
    """The launchers' ``--mesh``: ``debug`` is (world / m, m) with m = 2
    when the world is even and above one, else 1 (one device, ``None``,
    with no process group); ``single`` / ``multi`` the production meshes.
    The reference's rule (``launch/train.py``), over ranks instead of
    devices."""
    if args.mesh == "single":
        return make_production_mesh()
    if args.mesh == "multi":
        return make_production_mesh(multi_pod=True)
    if not (dist.is_available() and dist.is_initialized()):
        return None
    n = dist.get_world_size()
    model = 2 if n % 2 == 0 else 1
    return make_debug_mesh(data=n // model, model=model)
