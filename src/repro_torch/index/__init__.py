"""repro_torch.index — the sharded, out-of-core genome index, the twin of
``repro.index``: an index directory written by either package loads in
the other.

* :func:`build_sharded_index` — streamed, tile-by-tile construction with
  bounded host memory, partitioned by ``hash32(kmer) % num_partitions``;
  each tile's minimizers from the minimizer kernel on the card
  (``backend="cuda"``) or its plain version (``"torch"``);
* the persistent on-disk format (versioned JSON manifest + per-partition
  memmap CSR files + 2-bit packed reference) with integrity checking —
  :func:`open_index` / :func:`load_index` / :func:`verify_index`;
* shard-routed execution — a :class:`ShardedGenomeIndex` plugs into
  ``Mapper`` under a device-memory budget (lazy/LRU partition residency
  in a CUDA arena, ``repro_torch.index.residency``).

:func:`shard_flat_index` partitions an in-memory ``GenomeIndex`` without
touching disk.
"""
from .build import build_sharded_index
from .format import (FORMAT_VERSION, IndexFormatError, IndexIntegrityError,
                     MANIFEST_NAME, PackedReference, load_manifest,
                     pack_codes, unpack_codes)
from .sharded import (Partition, ShardedGenomeIndex, load_index, open_index,
                      shard_flat_index, verify_index)

__all__ = [
    "FORMAT_VERSION",
    "MANIFEST_NAME",
    "IndexFormatError",
    "IndexIntegrityError",
    "PackedReference",
    "Partition",
    "ShardedGenomeIndex",
    "build_sharded_index",
    "load_index",
    "load_manifest",
    "open_index",
    "pack_codes",
    "shard_flat_index",
    "unpack_codes",
    "verify_index",
]
