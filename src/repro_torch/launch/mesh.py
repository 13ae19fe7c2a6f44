"""Mesh construction (production + genomics service) — torch twin of
``repro.launch.mesh``.

``make_production_mesh`` is the LM's ``torch.distributed`` device mesh,
(16, 16) ("data", "model") or (2, 16, 16) ("pod", "data", "model"): one
rank a device, so it needs a process group of 256 or 512 ranks (NCCL
across cards; the dry run's fake group on the CPU).  ``named`` maps a
tree of partition specs (``models.layers.P``) to DTensor placements on a
mesh and ``distribute`` places a tree of tensors so.

``make_genomics_mesh`` builds the flat shard mesh of
``core.distributed.ShardMesh``: N logical shards on one device (the local
form, what one H100 runs), or one shard per rank of a
``torch.distributed`` process group (NCCL across cards, gloo on the CPU).
It lives in ``core.distributed``, which the ``Mapper`` session uses
without depending on this package.

Functions, not module-level constants: importing this module touches no
device or process group.
"""
from __future__ import annotations

from ..core.distributed import ShardMesh, make_genomics_mesh
from ..core.tree import tree_map
from ..models.layers import Sharding, placements

__all__ = ["ShardMesh", "make_genomics_mesh", "make_production_mesh",
           "make_mesh", "batch_axes", "named", "distribute"]


_MESHES: dict = {}


def make_mesh(shape: tuple, axes: tuple, device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group, whose world size must be the mesh's size.
    ``device_type``: "cuda" or "cpu" (default: "cuda" where a card is
    present).  The same arguments on the same group give the same mesh:
    its sub-groups are made once, and DTensor's sharding-propagation cache
    (keyed by mesh) is filled once."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    key = (tuple(shape), tuple(axes), device_type, dist.group.WORLD)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(device_type, tuple(shape),
                                        mesh_dim_names=tuple(axes))
    return _MESHES[key]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def batch_axes(mesh) -> tuple:
    """Mesh axes carrying data parallelism."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def named(mesh, spec_tree):
    """Map a tree of ``P`` to ``Sharding``s (DTensor placements) on
    ``mesh`` (``models.layers.placements``)."""
    return tree_map(lambda s: Sharding(mesh, placements(mesh, s)),
                    spec_tree)


def distribute(tree, mesh, spec_tree):
    """``tree``'s tensors as DTensors on ``mesh``, each placed as its
    ``P`` in ``spec_tree`` says.  Every rank passes the same whole tensor
    and keeps its own shard of it (no collective); a ``meta`` or fake
    tensor gives a DTensor of the same kind (the dry run's)."""
    return tree_map(lambda t, s: s.place(t), tree, named(mesh, spec_tree))
