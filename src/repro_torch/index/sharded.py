"""``ShardedGenomeIndex`` — the partitioned index as a session object,
the twin of ``repro.index.sharded``.

Minimizers are assigned to partition ``hash32(kmer) % P`` (the crossbar
rule); each partition is a self-contained CSR + segment store, and the
whole thing lives either

* **on disk** (``open_index`` / ``load_index`` over the directory format
  of ``index.format``, built by ``index.build``, by this package or the
  reference), memmapped so cold-start touches only the pages a run
  needs, or
* **in memory** (``shard_flat_index`` partitions an existing
  ``GenomeIndex``), for tests and small references.

``Mapper(index)`` (``topology="single"``) routes reads to partitions on
the host with lazy/LRU residency in a device arena under a memory budget
(``index.residency``); ``Mapper(index, topology="mesh")`` places
partition *i* on mesh shard *i* (``to_mesh_shards``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.index import GenomeIndex, validate_geometry
from ..io.fasta import Contig, ReferenceMap
from . import format as fmt
from .npscan import np_hash32


@dataclasses.dataclass
class Partition:
    """One partition's CSR + segments (arrays may be memmaps)."""
    kmers: np.ndarray       # (n_kmers,) uint32, sorted
    offsets: np.ndarray     # (n_kmers+1,) int32/int64 CSR
    positions: np.ndarray   # (n_occ,) int32/int64
    seg_len: int
    segments_raw: np.ndarray | None = None    # (n_occ, seg_len) uint8
    seg2bit: np.ndarray | None = None         # packed on-disk form
    segsent: np.ndarray | None = None
    _seg_cache: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n_kmers(self) -> int:
        return len(self.kmers)

    @property
    def n_occurrences(self) -> int:
        return len(self.positions)

    def read_segments(self) -> np.ndarray:
        """Materialize (n_occ, seg_len) uint8 segments, **uncached** —
        the residency layer calls this on partition load and must not
        leave a host copy pinned behind the device budget."""
        if self.segments_raw is not None:
            return np.asarray(self.segments_raw)
        if self.n_occurrences == 0:
            return np.zeros((0, self.seg_len), dtype=np.uint8)
        return fmt.unpack_codes(np.asarray(self.seg2bit),
                                np.asarray(self.segsent), self.seg_len)

    @property
    def segments(self) -> np.ndarray:
        """Cached materialized segments (tests / to_genome_index)."""
        if self.segments_raw is not None:
            return np.asarray(self.segments_raw)
        if self._seg_cache is None:
            self._seg_cache = self.read_segments()
        return self._seg_cache

    def storage_bytes(self) -> dict:
        """True on-disk footprint of this partition (2-bit packed)."""
        seg = (self.n_occurrences
               * (fmt.packed_cols(self.seg_len)
                  + fmt.sentinel_cols(self.seg_len)))
        hash_table = (self.kmers.nbytes + self.offsets.nbytes
                      + self.positions.nbytes)
        return {"hash_table_bytes": int(hash_table),
                "segments_bytes": int(seg),
                "n_kmers": self.n_kmers,
                "n_occurrences": self.n_occurrences}


@dataclasses.dataclass
class ShardedGenomeIndex:
    """Minimizer-partitioned genome index (P partitions, crossbar rule)."""
    parts: list
    read_len: int
    k: int
    w: int
    eth: int
    spacer: int
    ref_len: int
    contigs: list
    max_pls_per_minimizer: int = 256
    path: str | None = None
    manifest: dict | None = None
    packed_ref: fmt.PackedReference | None = None

    def __post_init__(self):
        validate_geometry(read_len=self.read_len, k=self.k, w=self.w,
                          eth=self.eth)

    # -- geometry (mirrors GenomeIndex so MapperConfig.from_index works) --
    @property
    def num_partitions(self) -> int:
        return len(self.parts)

    @property
    def seg_len(self) -> int:
        return 2 * (self.read_len + self.eth) - self.k

    @property
    def pad(self) -> int:
        return self.read_len + self.eth - self.k

    @property
    def n_occurrences(self) -> int:
        return sum(p.n_occurrences for p in self.parts)

    # ------------------------------------------------------------- routing
    def route(self, kmers: np.ndarray) -> np.ndarray:
        """Owning partition id per k-mer code — the crossbar rule."""
        return (np_hash32(np.asarray(kmers, np.uint32))
                % np.uint32(self.num_partitions)).astype(np.int32)

    def lookup(self, kmer: int) -> np.ndarray:
        """All minimizer positions of one k-mer code (host-side; the
        union-over-partitions property tests compare this against the
        flat ``GenomeIndex`` CSR)."""
        part = self.parts[int(self.route(np.array([kmer]))[0])]
        empty = np.zeros(0, dtype=np.asarray(part.positions).dtype)
        if part.n_kmers == 0:
            return empty
        i = int(np.searchsorted(part.kmers, np.uint32(kmer)))
        if i >= part.n_kmers or part.kmers[i] != np.uint32(kmer):
            return empty
        return np.asarray(part.positions[part.offsets[i]:
                                         part.offsets[i + 1]])

    def reference_map(self) -> ReferenceMap:
        return ReferenceMap(self.contigs)

    def reference_codes(self) -> np.ndarray:
        """The full spacer-concatenated reference as uint8 codes.

        Materializes ``ref_len`` bytes (the paired-end mate-rescue path
        needs the flat reference); only available when the index carries
        its packed reference (on-disk indexes always do).
        """
        if self.packed_ref is None:
            raise ValueError(
                "this ShardedGenomeIndex carries no packed reference "
                "(in-memory shard_flat_index without ref=); open an "
                "on-disk index or pass ref= when sharding")
        if self.packed_ref.origin:
            raise ValueError(
                f"this index sits at virtual origin "
                f"{self.packed_ref.origin}: materializing the flat "
                f"reference (paired mate rescue) is not supported on "
                f"origin-shifted indexes — map unpaired, or build the "
                f"index with origin=0")
        return self.packed_ref.codes()

    # -------------------------------------------------------- conversions
    def to_genome_index(self) -> GenomeIndex:
        """Merge partitions back into one flat ``GenomeIndex``.

        Materializes every segment — a test/compat spelling (it is the
        identity inverse of ``shard_flat_index``, which the equivalence
        suite asserts), not the way to map at scale.
        """
        ks = [np.asarray(p.kmers) for p in self.parts]
        all_k = np.concatenate(ks) if ks else np.zeros(0, np.uint32)
        counts = np.concatenate([np.diff(p.offsets) for p in self.parts]) \
            if ks else np.zeros(0, np.int64)
        order = np.argsort(all_k, kind="stable")
        pos_parts, seg_parts = [], []
        part_of = np.concatenate(
            [np.full(p.n_kmers, i, np.int32)
             for i, p in enumerate(self.parts)]) if ks else np.zeros(0)
        within = np.concatenate(
            [np.arange(p.n_kmers, dtype=np.int64) for p in self.parts]) \
            if ks else np.zeros(0, np.int64)
        for oi in order:
            p = self.parts[int(part_of[oi])]
            i = int(within[oi])
            lo, hi = int(p.offsets[i]), int(p.offsets[i + 1])
            pos_parts.append(np.asarray(p.positions[lo:hi]))
            seg_parts.append(p.segments[lo:hi])
        positions = (np.concatenate(pos_parts) if pos_parts
                     else np.zeros(0, np.int32))
        segments = (np.concatenate(seg_parts) if seg_parts
                    else np.zeros((0, self.seg_len), np.uint8))
        # int64-accumulated CSR, narrowed only when safe: an int32 cumsum
        # here wraps silently past 2^31 total occurrences
        offsets = fmt.csr_offsets(counts[order])
        return GenomeIndex.from_arrays(
            all_k[order], offsets, positions, segments,
            read_len=self.read_len, k=self.k, w=self.w, eth=self.eth)

    def to_mesh_shards(self):
        """Stack partitions into the mesh's padded per-shard layout
        (``core.distributed.ShardedIndex``) — partition *i* goes to shard
        *i*, nothing is re-hashed."""
        from ..core.distributed import ShardedIndex
        if self.ref_len - 1 > fmt.INT32_MAX:
            raise ValueError(
                f"mesh shards hold int32 positions but this index ends at "
                f"global position {self.ref_len - 1} (> {fmt.INT32_MAX}); "
                f"map references past 2^31 bases on topology='single', "
                f"which routes through the int64-clean device arena")
        return ShardedIndex.from_partitions(
            [(np.asarray(p.kmers), np.asarray(p.offsets).astype(np.int32),
              np.asarray(p.positions).astype(np.int32), p.read_segments())
             for p in self.parts],
            read_len=self.read_len, k=self.k, w=self.w, eth=self.eth,
            seg_len=self.seg_len)

    # ----------------------------------------------------------- accounting
    def storage_bytes(self) -> dict:
        """On-disk footprint with the per-partition breakdown."""
        per_part = []
        for i, p in enumerate(self.parts):
            d = p.storage_bytes()
            d["partition"] = i
            per_part.append(d)
        hash_table = sum(d["hash_table_bytes"] for d in per_part)
        seg = sum(d["segments_bytes"] for d in per_part)
        origin = self.packed_ref.origin if self.packed_ref else 0
        phys = self.ref_len - origin  # ref_len is the global end (v2)
        ref = fmt.packed_cols(phys) + fmt.sentinel_cols(phys)
        return {
            "hash_table_bytes": int(hash_table),
            "materialized_segments_bytes": int(seg),
            "reference_bytes": int(ref),
            "total_bytes": int(hash_table + seg + ref),
            "blowup": seg / max(hash_table, 1),
            "num_partitions": self.num_partitions,
            "per_partition": per_part,
        }


def shard_flat_index(index: GenomeIndex, num_partitions: int, *,
                     contigs: list | None = None, spacer: int | None = None,
                     ref: np.ndarray | None = None) -> ShardedGenomeIndex:
    """Partition an in-memory ``GenomeIndex`` by the crossbar rule.

    The in-memory twin of ``build_sharded_index``: same partition
    assignment, same per-partition (kmer, pos) order, no disk.  ``ref``
    (the flat reference codes) is optional and only needed when the
    result must serve ``reference_codes()`` (paired mate rescue).
    """
    from .build import _validate_partitions
    _validate_partitions(num_partitions)
    P = int(num_partitions)
    # the flat index's positions in the on-disk dtype rule (the port's
    # GenomeIndex holds them int64)
    pos = np.asarray(index.positions)
    pos_dtype = fmt.position_dtype(int(pos.max()) if len(pos) else 0)
    h = np.asarray(np_hash32(index.uniq_kmers)) % P
    counts = np.diff(index.offsets)
    parts = []
    for p in range(P):
        sel = np.where(h == p)[0]
        kmers = index.uniq_kmers[sel]
        pc = counts[sel]
        # int64 cumsum, narrowed when safe (satellite of the v2 audit:
        # the old int32 cumsum wrapped before the int64 repeat below)
        offsets = fmt.csr_offsets(pc)
        idx = (np.repeat(index.offsets[sel].astype(np.int64), pc)
               + (np.arange(int(pc.sum()), dtype=np.int64)
                  - np.repeat(offsets[:-1].astype(np.int64), pc)))
        parts.append(Partition(
            kmers=kmers.astype(np.uint32), offsets=offsets,
            positions=np.asarray(index.positions)[idx].astype(pos_dtype),
            seg_len=index.seg_len,
            segments_raw=index.segments[idx]))
    if contigs is None:
        if ref is not None:
            ref_len = len(ref)
        elif len(index.positions):
            # positions are minimizer k-mer starts; the farthest one can
            # sit up to w+k-2 bases short of the reference end (leftmost
            # k-mer of the final window), so use the geometric upper
            # bound.  Pass ref=/contigs= when exact lengths matter.
            ref_len = int(index.positions.max()) + index.w + index.k - 1
        else:
            ref_len = 0
        contigs = [Contig(name="ref", length=ref_len, offset=0)]
    packed = None
    if ref is not None:
        p2, sb = fmt.pack_codes(np.asarray(ref, np.uint8))
        packed = fmt.PackedReference(p2, sb, len(ref))
    return ShardedGenomeIndex(
        parts=parts, read_len=index.read_len, k=index.k, w=index.w,
        eth=index.eth,
        spacer=spacer if spacer is not None else
        index.read_len + 2 * index.eth,
        ref_len=packed.length if packed else
        max((c.offset + c.length for c in contigs), default=0),
        contigs=contigs, packed_ref=packed)


def open_index(index_dir: str, *, mmap: bool = True,
               verify: str = "size") -> ShardedGenomeIndex:
    """Open a persistent index directory.

    ``mmap=True`` (default) memory-maps every array — cold-start cost is
    the manifest plus file-size checks, and pages fault in as mapping
    touches them.  ``verify``: ``"none"`` trusts the directory,
    ``"size"`` (default) checks every file's byte size against the
    manifest, ``"full"`` additionally streams every file through crc32.
    """
    if verify not in ("none", "size", "full"):
        raise ValueError(f"verify={verify!r}; expected 'none', 'size' or "
                         f"'full'")
    man = fmt.load_manifest(index_dir)
    if verify != "none":
        fmt.check_integrity(index_dir, man, full=verify == "full")
    seg_len = 2 * (man["read_len"] + man["eth"]) - man["k"]
    if man["seg_len"] != seg_len:
        raise fmt.IndexFormatError(
            f"{index_dir}: manifest seg_len={man['seg_len']} does not match "
            f"geometry 2*(read_len+eth)-k={seg_len}; manifest is corrupt")
    parts = []
    for pm in man["partitions"]:
        pf = fmt.load_partition(index_dir, pm["id"], mmap=mmap)
        if (len(pf.kmers) != pm["n_kmers"]
                or len(pf.offsets) != pm["n_kmers"] + 1
                or len(pf.positions) != pm["n_occurrences"]
                or pf.seg2bit.shape != (pm["n_occurrences"],
                                        fmt.packed_cols(seg_len))):
            raise fmt.IndexIntegrityError(
                f"{index_dir}: partition {pm['id']} array shapes disagree "
                f"with the manifest (kmers {len(pf.kmers)}/{pm['n_kmers']}, "
                f"positions {len(pf.positions)}/{pm['n_occurrences']}); "
                f"rebuild the index")
        if str(pf.positions.dtype) != man["position_dtype"]:
            raise fmt.IndexIntegrityError(
                f"{index_dir}: partition {pm['id']} positions are "
                f"{pf.positions.dtype} but the manifest says "
                f"{man['position_dtype']}; rebuild the index")
        parts.append(Partition(kmers=pf.kmers, offsets=pf.offsets,
                               positions=pf.positions, seg_len=seg_len,
                               seg2bit=pf.seg2bit, segsent=pf.segsent))
    contigs = [Contig(name=c["name"], length=c["length"], offset=c["offset"])
               for c in man["contigs"]]
    return ShardedGenomeIndex(
        parts=parts, read_len=man["read_len"], k=man["k"], w=man["w"],
        eth=man["eth"], spacer=man["spacer"], ref_len=man["ref_len"],
        contigs=contigs,
        max_pls_per_minimizer=man["max_pls_per_minimizer"],
        path=index_dir, manifest=man,
        packed_ref=fmt.load_reference(index_dir, man, mmap=mmap))


def load_index(index_dir: str) -> ShardedGenomeIndex:
    """Fully load an index into RAM with full crc32 verification."""
    return open_index(index_dir, mmap=False, verify="full")


def verify_index(index_dir: str) -> dict:
    """Full-integrity check; returns the manifest or raises
    ``IndexIntegrityError`` listing every mismatching file."""
    man = fmt.load_manifest(index_dir)
    fmt.check_integrity(index_dir, man, full=True)
    return man
