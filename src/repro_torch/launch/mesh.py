"""Mesh construction for the distributed read mapper — the genomics part
of ``repro.launch.mesh``.

``make_genomics_mesh`` builds the flat shard mesh of
``core.distributed.ShardMesh``: N logical shards on one device (the local
form, what one H100 runs), or one shard per rank of a
``torch.distributed`` process group (NCCL across cards, gloo on the CPU).
It lives in ``core.distributed``, which the ``Mapper`` session uses
without depending on this package.  The production LM meshes
(``make_production_mesh``, ``batch_axes``, ``named``) are LM scaffolding
and not ported (ROADMAP.md, Queue 1 item 11).
"""
from __future__ import annotations

from ..core.distributed import ShardMesh, make_genomics_mesh

__all__ = ["ShardMesh", "make_genomics_mesh"]
