"""Lazy/LRU device residency + shard-routed single-device execution — the
twin of ``repro.index.residency``, with the arena in CUDA memory.

The ``Mapper`` owns a fixed-capacity **device arena** — one ``(cap_rows,
seg_len)`` uint8 segments tensor and one ``(cap_rows,)`` positions tensor
sized by ``memory_budget_bytes`` — and partitions move in and out of it
at chunk granularity:

* ``seed_reads_routed`` extracts each chunk's minimizers (the minimizer
  kernel on ``wf_backend="cuda"``) and routes them on the host by the
  crossbar rule, so the partitions a chunk touches are known before any
  of its engine work;
* ``DeviceResidency.ensure`` makes those partitions resident: hits touch
  the LRU, misses take a free extent, evicting least-recently-used
  partitions (never ones the current chunk needs) and compacting when
  free space is fragmented — the reference's decisions, counters and
  error messages, on the same row size (``arena_position_dtype``);
* emitted ``occ_idx`` rows are arena rows.

**Write ordering.**  The reference's arena is functional: a chunk keeps
the arrays it was routed against while later loads build new ones.  This
arena is written in place, and the chunk schedule routes chunk i+1
(``phase1``, on the prefetch worker with ``prefetch=True``) before chunk
i's engine work is queued (``phase2``).  So ``ensure`` only *decides*:
the uploads and compaction moves it implies are recorded against the
routing's ticket (``ticket``), and ``snapshot(upto=ticket)`` applies
them, in routing order, when that chunk's ``phase2`` asks for its arena
(``chunk_index``).  Every arena write is therefore queued on the compute
stream after the work of every chunk routed before it, and no load
overwrites rows that an earlier chunk still reads.  The expensive host
part of a load (reading the partition's packed pages into pinned
staging) happens inside ``ensure``, on the prefetch worker when there is
one; the copy to the card and the 2-bit unpack run on the compute
stream.  Compaction moves rows leftward through pieces that never
overlap their destination (``_move_rows``).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.encoding import SENTINEL
from ..core.pipeline import MapperConfig, _ChunkPipeline, _copy_args
from ..core.seeding import seed_reads_routed
from ..obs import registry as _metrics
from ..obs.tracing import span as _span

# arena rows unpacked from 2-bit staging a step, and the rows a
# compaction copies through a scratch buffer a step
_UNPACK_ROWS = 1 << 20
_SCRATCH_ROWS = 1 << 16


def arena_position_dtype(ref_len: int) -> torch.dtype:
    """Arena dtype of positions of a reference ending at global position
    ``ref_len - 1``: 32-bit words (int32, read as unsigned) below 2^32 - 1
    — the 4 bytes a row the reference's arena holds there (int32, then
    uint32) — and int64 past that, where the reference needs jax's x64
    (``repro.core.index.device_position_dtype``).  The engines widen
    what they gather (``core.pipeline._cand_positions``)."""
    if int(ref_len) - 1 < np.iinfo(np.uint32).max:
        return torch.int32
    return torch.int64


def _unpack_rows(packed: torch.Tensor, sent: torch.Tensor,
                 seg_len: int) -> torch.Tensor:
    """``format.unpack_codes`` on the device: (n, ceil(seg_len/4)) 2-bit
    bytes and (n, ceil(seg_len/8)) sentinel bits -> (n, seg_len) codes."""
    n = packed.shape[0]
    shifts2 = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    bases = ((packed[..., None] >> shifts2) & 3).reshape(n, -1)[:, :seg_len]
    shifts1 = torch.arange(8, dtype=torch.uint8, device=packed.device)
    s = ((sent[..., None] >> shifts1) & 1).reshape(n, -1)[:, :seg_len]
    return torch.where(s.bool(), torch.full_like(bases, SENTINEL), bases)


def _move_rows(t: torch.Tensor, src: int, dst: int, rows: int) -> None:
    """``t[dst:dst+rows] = t[src:src+rows]`` for a leftward move (dst <
    src) without an overlapping copy: pieces no longer than the shift go
    straight across (a piece's destination then ends where its source
    starts); longer pieces go through a scratch copy of ``_SCRATCH_ROWS``
    rows at most.  Left to right, a piece never reads rows an earlier
    piece wrote."""
    step = src - dst
    piece = min(rows, max(step, _SCRATCH_ROWS))
    for j in range(0, rows, piece):
        m = min(piece, rows - j)
        blk = t[src + j: src + j + m]
        if m > step:
            blk = blk.clone()
        t[dst + j: dst + j + m] = blk


class DeviceResidency:
    """Partition-granular device arena under a byte budget."""

    def __init__(self, index, memory_budget_bytes: int | None = None, *,
                 device=None):
        self.index = index
        self.device = resolve_device(device)
        seg_len = index.seg_len
        self.pos_dtype = arena_position_dtype(getattr(index, "ref_len", 0))
        # one occurrence row = seg_len segment bytes + position bytes
        self.row_bytes = seg_len + self.pos_dtype.itemsize
        rows = [p.n_occurrences for p in index.parts]
        total = sum(rows)
        biggest = max(rows, default=0)
        if memory_budget_bytes is None:
            cap_rows = max(total, 1)
        else:
            cap_rows = max(int(memory_budget_bytes) // self.row_bytes, 0)
            if cap_rows < max(biggest, 1):
                need = max(biggest, 1) * self.row_bytes
                raise ValueError(
                    f"memory_budget_bytes={memory_budget_bytes} holds "
                    f"{cap_rows} occurrence rows ({self.row_bytes} B/row) "
                    f"but the largest partition needs {max(biggest, 1)} "
                    f"rows; raise the budget to >= {need} bytes or rebuild "
                    f"the index with more partitions")
        self.cap_rows = cap_rows
        self.budget_bytes = memory_budget_bytes
        self.segments_dev = torch.zeros((cap_rows, seg_len), dtype=torch.uint8,
                                        device=self.device)
        self.positions_dev = torch.zeros((cap_rows,), dtype=self.pos_dtype,
                                         device=self.device)
        self._alloc: dict[int, tuple[int, int]] = {}   # p -> (lo, rows)
        self._lru: OrderedDict[int, None] = OrderedDict()
        # one re-entrant lock over all residency state: the prefetch
        # worker and the compute path may ensure() concurrently, and a
        # partition must load exactly once with exactly one allocation
        self._lock = threading.RLock()
        self._prefetched: set[int] = set()
        # arena writes decided and not applied yet: (ticket, op); the
        # ticket of writes being recorded now, and one lock so that
        # snapshots apply them one caller at a time, in order
        self._writes: list = []
        self._ticket = 0
        self._apply_lock = threading.Lock()
        self.loads = 0
        self.evictions = 0
        self.compactions = 0
        self.h2d_bytes = 0
        self.prefetch_loads = 0
        self.prefetch_hits = 0

    # ------------------------------------------------------------- queries
    @property
    def resident(self) -> list:
        return sorted(self._alloc)

    @property
    def resident_rows(self) -> int:
        return sum(r for _, r in self._alloc.values())

    def ticket(self) -> int:
        """Close the arena writes recorded so far under one ticket and
        return it: a chunk routed by the ``ensure`` just before reads the
        arena through ``snapshot(upto=<this ticket>)``.  Take it under
        ``_lock`` together with that ``ensure``."""
        with self._lock:
            t = self._ticket
            self._ticket += 1
            return t

    def snapshot(self, upto: int | None = None):
        """The arena tensors ``(positions, segments)`` with every write of
        tickets ``<= upto`` (all recorded writes when None) queued on the
        current stream, in the order ``ensure`` decided them.  A chunk
        calls it with its own ticket when its engine work is about to be
        queued, so writes for chunks routed after it come after its reads
        on the stream."""
        with self._apply_lock:
            with self._lock:
                n = len(self._writes)
                if upto is not None:
                    n = next((i for i, (t, _) in enumerate(self._writes)
                              if t > upto), n)
                todo, self._writes = self._writes[:n], self._writes[n:]
            for _, op in todo:
                self._apply(*op)
        return self.positions_dev, self.segments_dev

    # ----------------------------------------------------------- residency
    def ensure(self, parts: list, *, prefetch: bool = False) -> dict:
        """Make ``parts`` resident; returns ``{p: arena_base_row}``.

        ``prefetch=True`` marks this call as coming from the background
        prefetch worker: its loads count as prefetch loads, and the
        partitions it stages are credited as prefetch hits when a later
        ensure finds them still resident.  Thread-safe: the whole
        operation holds the residency lock, so two ensures racing on the
        same partition load it exactly once with one allocation.  The
        arena writes it implies are recorded, not applied (``snapshot``).
        """
        with self._lock:
            pinned = set(parts)
            hits = misses = pf_hits = 0
            for p in parts:
                if p in self._alloc:
                    self._lru.move_to_end(p)
                    hits += 1
                    if p in self._prefetched:
                        pf_hits += 1
                        self._prefetched.discard(p)
            for p in parts:
                if p not in self._alloc:
                    misses += 1
                    self._load(p, pinned, prefetch=prefetch)
            if prefetch:
                self._prefetched.update(parts)
            self.prefetch_hits += pf_hits
            reg = _metrics.ACTIVE
            if reg is not None:
                if hits:
                    reg.counter("repro_partition_hits_total").inc(hits)
                if misses:
                    reg.counter("repro_partition_misses_total").inc(misses)
                if pf_hits:
                    reg.counter(
                        "repro_partition_prefetch_hits_total").inc(pf_hits)
                reg.gauge("repro_partition_resident_rows").set(
                    self.resident_rows)
            # Bases must come from the allocation table only after every
            # load: a late ``_load`` may ``_compact`` and relocate
            # partitions that were already resident when ensure() started.
            return {p: self._alloc[p][0] for p in parts}

    def prefetch(self, parts: list) -> dict | None:
        """Best-effort background staging of ``parts``: ``ensure(parts,
        prefetch=True)``, except that a budget overflow returns None
        instead of raising — the authoritative ensure on the compute path
        reports the error with the chunk that actually needs them."""
        try:
            return self.ensure(parts, prefetch=True)
        except ValueError:
            return None

    def _free_extents(self):
        used = sorted(self._alloc.values())
        extents, cursor = [], 0
        for lo, rows in used:
            if lo > cursor:
                extents.append((cursor, lo - cursor))
            cursor = lo + rows
        if cursor < self.cap_rows:
            extents.append((cursor, self.cap_rows - cursor))
        return extents

    def _find_gap(self, rows: int):
        for lo, size in self._free_extents():
            if size >= rows:
                return lo
        return None

    def _evict_one(self, pinned: set, incoming_rows: int = 0) -> None:
        victim = next((q for q in self._lru if q not in pinned), None)
        if victim is None:
            # Every unpinned resident has already been evicted: the rows
            # still held all belong to partitions this chunk needs, so
            # the report must count held + incoming, not pretend the
            # whole arena were free.
            held = self.resident_rows
            need = sum(self.index.parts[p].n_occurrences for p in pinned)
            raise ValueError(
                f"one chunk touches partitions needing {need} occurrence "
                f"rows but the arena holds {self.cap_rows}: every "
                f"unpinned resident is already evicted and {held} rows "
                f"stay pinned by this chunk while {incoming_rows} more "
                f"are loading; raise memory_budget_bytes (>= "
                f"{need * self.row_bytes} bytes) or shrink chunk_reads "
                f"so fewer partitions are touched at once")
        del self._alloc[victim]
        del self._lru[victim]
        self._prefetched.discard(victim)
        self.evictions += 1
        reg = _metrics.ACTIVE
        if reg is not None:
            reg.counter("repro_partition_evictions_total").inc()

    def _compact(self) -> None:
        """Repack resident partitions to the arena front, sorted
        ascending, so every move is leftward into space already vacated
        (recorded, applied by ``snapshot``)."""
        self.compactions += 1
        reg = _metrics.ACTIVE
        if reg is not None:
            reg.counter("repro_partition_compactions_total").inc()
        cursor = 0
        for p, (lo, rows) in sorted(self._alloc.items(),
                                    key=lambda kv: kv[1][0]):
            if lo != cursor:
                self._writes.append((self._ticket, ("move", lo, cursor,
                                                    rows)))
                self._alloc[p] = (cursor, rows)
            cursor += rows

    def _stage(self, part):
        """Host staging of one partition's rows: its positions in the
        arena dtype and its segments, 2-bit packed as on disk (or raw for
        an in-memory partition), in pinned memory when the arena is on
        the card."""
        pos = np.asarray(part.positions).astype(np.int64)
        pos = (pos.astype(np.uint32).view(np.int32)
               if self.pos_dtype == torch.int32 else pos)
        arrays = ([part.segments_raw] if part.segments_raw is not None
                  else [part.seg2bit, part.segsent])
        out = []
        for a in [pos] + arrays:
            a = np.asarray(a)
            if self.device.type == "cuda":
                t = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                                pin_memory=True)
                t.numpy()[...] = a
            else:
                t = torch.from_numpy(np.array(a))
            out.append(t)
        return out

    def _load(self, p: int, pinned: set, *, prefetch: bool = False) -> int:
        part = self.index.parts[p]
        rows = part.n_occurrences
        while True:
            lo = self._find_gap(rows)
            if lo is not None:
                break
            if (self.cap_rows - self.resident_rows) >= rows:
                self._compact()     # space exists but is fragmented
                continue
            self._evict_one(pinned, incoming_rows=rows)
        self._writes.append((self._ticket, ("load", lo, rows,
                                            self._stage(part))))
        self._alloc[p] = (lo, rows)
        self._lru[p] = None
        self._lru.move_to_end(p)
        self.loads += 1
        if prefetch:
            self.prefetch_loads += 1
        self.h2d_bytes += rows * self.row_bytes
        reg = _metrics.ACTIVE
        if reg is not None:
            reg.counter("repro_partition_loads_total").inc()
            if prefetch:
                reg.counter("repro_partition_prefetch_loads_total").inc()
            reg.counter("repro_partition_h2d_bytes_total").inc(
                rows * self.row_bytes)
        return lo

    def _apply(self, kind: str, *args) -> None:
        """Queue one recorded arena write on the current stream."""
        if kind == "move":
            src, dst, rows = args
            _move_rows(self.segments_dev, src, dst, rows)
            _move_rows(self.positions_dev, src, dst, rows)
            return
        lo, rows, staged = args
        dev = self.device
        self.positions_dev[lo:lo + rows] = staged[0].to(dev, non_blocking=True)
        if len(staged) == 2:                        # raw segments
            self.segments_dev[lo:lo + rows] = staged[1].to(
                dev, non_blocking=True)
            return
        seg_len = self.segments_dev.shape[1]
        for a in range(0, rows, _UNPACK_ROWS):
            b = min(a + _UNPACK_ROWS, rows)
            self.segments_dev[lo + a:lo + b] = _unpack_rows(
                staged[1][a:b].to(dev, non_blocking=True),
                staged[2][a:b].to(dev, non_blocking=True), seg_len)

    # ------------------------------------------------------------- stats
    def stats_summary(self, *, reset: bool = True) -> dict:
        out = {
            "partition_loads": self.loads,
            "partition_evictions": self.evictions,
            "partition_compactions": self.compactions,
            "h2d_bytes": self.h2d_bytes,
            "prefetch_loads": self.prefetch_loads,
            "prefetch_hits": self.prefetch_hits,
            "resident_partitions": self.resident,
            "resident_rows": self.resident_rows,
            "arena_rows": self.cap_rows,
            "arena_bytes": self.cap_rows * self.row_bytes,
        }
        if reset:
            self.loads = self.evictions = self.compactions = 0
            self.h2d_bytes = 0
            self.prefetch_loads = self.prefetch_hits = 0
        return out


class ShardRouter:
    """Per-session routing front-end: seeding + residency + stats."""

    def __init__(self, index, residency: DeviceResidency,
                 cfg: MapperConfig):
        self.index = index
        self.residency = residency
        self.cfg = cfg
        P = index.num_partitions
        self._routed = np.zeros(P, dtype=np.int64)
        self._found = np.zeros(P, dtype=np.int64)
        self._chunks = 0

    def seed(self, reads: np.ndarray, *, prefetch: bool = False):
        """Route + seed one (padded, possibly strand-stacked) chunk.
        Returns ``(numpy seeds, ticket)``: the chunk reads the arena
        through ``residency.snapshot(upto=ticket)``.

        The ensure and the ticket are taken under one hold of the
        residency lock, so no other routing's writes can land between the
        layout this chunk's ``occ_idx`` rows were computed against and
        its ticket."""
        res = self.residency
        got = {}

        def ensure(parts):
            with res._lock:
                bases = res.ensure(parts, prefetch=prefetch)
                got["ticket"] = res.ticket()
            return bases

        seeds, routed, found = seed_reads_routed(
            self.index, reads, self.cfg.seed_params, ensure,
            backend=self.cfg.wf_backend, device=res.device)
        with res._lock:
            self._routed += routed
            self._found += found
            self._chunks += 1
        return seeds, got["ticket"]

    def drain_stats(self) -> dict:
        """Per-partition accounting since the last drain (one run)."""
        out = {
            "chunks_routed": self._chunks,
            "minis_routed_per_partition": self._routed.tolist(),
            "minis_found_per_partition": self._found.tolist(),
            **self.residency.stats_summary(),
        }
        self._routed[:] = 0
        self._found[:] = 0
        self._chunks = 0
        return out


class _RoutedChunkPipeline(_ChunkPipeline):
    """``_ChunkPipeline`` with shard-routed seeding.

    phase1 replaces the device ``seed_reads`` with the router (minimizers,
    host routing + CSR lookups, residency) and uploads the finished seed
    tensors; phase2 and fetch are inherited — ``chunk_index`` hands phase2
    the arena with this chunk's writes applied (``snapshot(upto=ticket)``).

    With ``prefetch=True`` a single background worker runs the host
    prep (pad + revcomp + route + seed + partition staging) for chunk
    i+1 while chunk i's device work is in flight: ``begin_run`` stages
    the first chunk, and each ``phase1`` submits the next item before
    consuming its own future.  On the card the worker queues its
    minimizer scans on a stream of its own.  Results are bit-identical
    to synchronous loading: every chunk reads the arena at its own
    ticket.
    """

    def __init__(self, router: ShardRouter, cfg: MapperConfig,
                 device: torch.device, prefetch: bool = False):
        super().__init__(None, cfg, device)
        self.router = router
        self.prefetch = prefetch
        self._ex = None
        self._side = None
        self._pf_items: list = []
        self._pf_futs: list = []
        self._pf_i = 0
        self._pf_times = None

    def begin_run(self, items, times=None) -> None:
        """Stage the first chunk's host prep on the prefetch worker, whose
        stage spans add to ``times``."""
        if not (self.prefetch and self.cfg.stream and items):
            return
        if self._ex is None:
            self._ex = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="arena-prefetch")
            if self.device.type == "cuda":
                self._side = torch.cuda.Stream(self.device)
        self._pf_items = list(items)
        self._pf_futs = [None] * len(self._pf_items)
        self._pf_i = 0
        self._pf_times = times
        self._pf_futs[0] = self._ex.submit(self._staged_prep,
                                           self._pf_items[0])

    def close(self) -> None:
        """Shut the prefetch worker down (no-op if it never started)."""
        if self._ex is not None:
            self._ex.shutdown(wait=True)
            self._ex = None

    def _staged_prep(self, item):
        if self._side is None:
            return self._prep(item, prefetch=True, times=self._pf_times)
        with torch.cuda.stream(self._side):
            return self._prep(item, prefetch=True, times=self._pf_times)

    def _prep(self, item, *, prefetch: bool, times=None):
        """Host-side chunk prep: pad, strand-stack, route + seed (which
        stages any missing partitions).  Runs on the prefetch worker or
        inline on the main thread — the residency lock serializes them."""
        sub, n_real = self.host_prep(item, times)
        with _span("seed", times):
            seeds_np, ticket = self.router.seed(sub, prefetch=prefetch)
        return sub, seeds_np, ticket, n_real

    def phase1(self, item, times=None):
        staged = (self._pf_futs and self._pf_i < len(self._pf_items)
                  and self._pf_items[self._pf_i] is item)
        if staged:
            i = self._pf_i
            self._pf_i += 1
            # submit the *next* item before blocking on this one: the
            # single worker runs them in order, so i is already done or
            # running and i+1 queues behind it
            if i + 1 < len(self._pf_items):
                self._pf_futs[i + 1] = self._ex.submit(
                    self._staged_prep, self._pf_items[i + 1])
            sub, seeds_np, ticket, n_real = self._pf_futs[i].result()
            self._pf_futs[i] = None
        else:
            sub, seeds_np, ticket, n_real = self._prep(
                item, prefetch=False, times=times)
        dev = self.device
        with _span("h2d", times) as sp:
            host = [torch.from_numpy(sub),
                    torch.from_numpy(seeds_np["mini_pos"]),
                    torch.from_numpy(seeds_np["occ_idx"]),
                    torch.from_numpy(seeds_np["occ_valid"])]
            reads, mini_pos, occ_idx, occ_valid = (t.to(dev) for t in host)
            seeds = {
                "mini_pos": mini_pos.long(),
                "occ_idx": occ_idx.long(),
                "occ_valid": occ_valid,
                "n_valid": seeds_np["n_valid"],
                "_ticket": ticket,
            }
            self._wait(reads)
            if sp is not None:
                _copy_args(sp, host)
        return reads, seeds, n_real

    def chunk_index(self, seeds):
        return self.router.residency.snapshot(upto=seeds.pop("_ticket"))
