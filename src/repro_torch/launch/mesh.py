"""Device meshes on ``torch.distributed``, with the reference package's
axes: ``data`` (data parallelism and FSDP), ``model`` (tensor and expert
parallelism) and, on a multi-pod mesh, an outer ``pod`` axis.

Each mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group, which the caller has started
(``torch.distributed.init_process_group`` with its address, world size and
rank: nothing on a machine tells a program of a cluster).  Functions, not
module constants, so importing this module touches no device or group.

The sharding rules read a mesh only through ``axis_sizes``, so a mesh-like
object with ``axis_names`` and a ``shape`` mapping (as the reference's mesh
has) serves as well as a ``DeviceMesh``: the tests hold the rules for 256
and 512 devices without them.
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16x16 = 256 cards a pod; 2 pods = 512 cards multi-pod.

    Axes: data (DP + FSDP), model (TP + EP); the pod axis defaults to an
    outer data-parallel dimension (pipeline over pods is available through
    ``distributed.pipeline_parallel``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape, axes, *, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with ``axes`` as its dimension names
    over the default group's ranks, in rank order (e.g. (4, 2) on 8
    ranks); ``device`` "cpu" for gloo groups."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a mesh-like object with
    ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def dp_axes(mesh) -> tuple:
    """Axes that carry data parallelism (pod + data when present)."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def tp_axis(mesh):
    return "model" if "model" in axis_sizes(mesh) else None
