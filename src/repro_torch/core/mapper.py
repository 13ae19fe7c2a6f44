"""The ``Mapper`` session — torch twin of ``repro.core.mapper``.

  ``Mapper(index, cfg, device=...)`` — places a flat ``GenomeIndex`` on
      the device once, or routes over a ``ShardedGenomeIndex`` through a
      budgeted device arena (``memory_budget_bytes=``, ``prefetch=``;
      ``index.residency``), and keeps a plan cache (with hit/miss
      counters) of per-chunk executables.
  ``Mapper.plan(spec)`` — the ``MappingPlan`` a run would execute (chunk
      sizes, lane-capacity ceilings; on the mesh the padded batch, send
      and survivor capacities) before anything runs.
  ``Mapper.run(plan, reads)`` / ``Mapper.map(reads)`` / ``map_async``.
  ``Mapper.map_pairs(reads1, reads2)`` — both mates in one stacked batch
      (pair resolution: ``core.pairing``).
  ``Mapper.serve()`` — a ``MappingService`` request batcher wired to this
      session (``core.serving``).

``topology=`` selects the back-end behind the same result schema:

  ``"single"`` — the chunk engines of ``core.pipeline`` (compacted, fused
      or padded), streamed.
  ``"mesh"``   — the distributed mapper of ``core.distributed`` over a
      ``ShardMesh``: N logical shards on one device (the local form) or
      one shard per rank of a ``torch.distributed`` group.  Reads are
      zero-padded up to a shard multiple and results trimmed back; stage
      B never tracebacks, so the traceback fields of ``MappingResult``
      are None on this path.

The session runs on the CUDA card unless ``device`` names another
device; with no GPU and no device given it raises.  Each run mirrors its
``MapperStats`` into the ``repro_torch.obs`` registry when metrics are
armed.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from ..kernels import ops
from ..obs import registry as _metrics
from ..obs import tracing as _tracing
from . import streaming
from .device import resolve_device
from .distributed import (ShardedIndex, make_distributed_mapper,
                          make_genomics_mesh, shard_index,
                          stage_b_affine_capacity)
from .encoding import revcomp
from .index import GenomeIndex
from .pipeline import (LazyTraceback, MapperConfig, MappingResult,
                       _CallArrays, _ChunkPipeline, _copy_args,
                       _merge_stats, map_reads_padded)

TOPOLOGIES = ("single", "mesh")

__all__ = ["Mapper", "MapperStats", "MappingPlan", "TOPOLOGIES",
           "accumulate_partition_stats", "accumulate_stats", "split_result",
           "totals_from_registry"]

_PER_READ_FIELDS = ("position", "distance", "distance2", "mapped", "strand",
                    "ops", "op_count", "linear_dist", "n_candidates",
                    "failed")


def split_result(res: MappingResult, n: int,
                 ) -> tuple[MappingResult, MappingResult]:
    """Split one stacked ``MappingResult`` into ``(first n, rest)``; both
    halves share ``stats``, and a lazy traceback holder is sliced, not
    materialized."""
    lt = object.__getattribute__(res, "lazy_tb")

    def half(lo, hi):
        def raw(f):
            v = object.__getattribute__(res, f)
            return v[lo:hi] if v is not None else None
        return MappingResult(**{f: raw(f) for f in _PER_READ_FIELDS},
                             stats=res.stats,
                             lazy_tb=lt[lo:hi] if lt is not None else None)
    return half(0, n), half(n, len(res.position))


@dataclasses.dataclass
class MapperStats:
    """Per-run statistics (``repro.core.mapper.MapperStats``'s schema).
    ``extra`` holds the per-path keys (``candidates_valid``,
    ``stage_times_s``, ...) and backs dict-style access."""
    topology: str
    engine: str
    reads: int                     # real reads mapped (padding excluded)
    candidates: int                # seeded candidates
    survivors: int                 # filter survivors admitted to affine
    affine_instances: int          # affine WF instances actually executed
    padded_affine_instances: int   # what the padded reference would run
    dropped_send: int = 0          # mesh: send-FIFO overflow drops
    dropped_affine: int = 0        # mesh: survivor-capacity overflow drops
    reverse_best: int = 0          # dual-strand runs: reads whose best
    #                                alignment used the reverse complement
    plan_cache_hits: int = 0       # session cumulative, sampled at run time
    plan_cache_misses: int = 0
    retries: int = 0               # resilience: block retries this run
    failed_reads: int = 0          # resilience: reads quarantined this run
    extra: dict = dataclasses.field(default_factory=dict)

    def __getitem__(self, key):
        return self.extra[key]

    def __contains__(self, key):
        return key in self.extra

    def get(self, key, default=None):
        return self.extra.get(key, default)

    def keys(self):
        return self.extra.keys()

    def as_dict(self) -> dict:
        return dict(self.extra)


_PART_SUM_KEYS = ("chunks_routed", "partition_loads", "partition_evictions",
                  "partition_compactions",
                  "h2d_bytes", "prefetch_loads", "prefetch_hits",
                  "minis_routed_per_partition",
                  "minis_found_per_partition", "survivors_per_partition")


def accumulate_partition_stats(totals: dict, stats) -> dict:
    """Merge a run's per-partition accounting (``stats["partitions"]``,
    present on sharded-index sessions) into ``totals["partitions"]``.
    Counters and per-partition count vectors sum across runs; static
    descriptors (arena size, current residency) take the latest run's
    value."""
    if not isinstance(stats, MapperStats):
        return totals
    part = stats.get("partitions")
    if not part:
        return totals
    acc = totals.setdefault("partitions", {})
    for k, v in part.items():
        if k in _PART_SUM_KEYS:
            if isinstance(v, list):
                prev = acc.get(k)
                acc[k] = ([a + b for a, b in zip(prev, v)] if prev
                          else list(v))
            else:
                acc[k] = acc.get(k, 0) + v
        else:
            acc[k] = v
    return totals


def accumulate_stats(totals: dict, stats, fields=None) -> dict:
    """Sum ``MapperStats`` fields into a running ``totals`` dict (the
    launchers' per-batch accumulation).  ``fields`` defaults to
    ``totals``'s own keys; a non-``MapperStats`` stats (padded engine:
    None) is a no-op."""
    if isinstance(stats, MapperStats):
        for k in (fields if fields is not None else tuple(totals)):
            totals[k] = totals.get(k, 0) + getattr(stats, k)
    return totals


# MapperStats fields mirrored into the metrics registry per run, and the
# fields ``totals_from_registry`` re-derives — keep the two in lockstep
# so registry-sourced closing stats equal the accumulated ones
_METRIC_RUN_FIELDS = ("reads", "candidates", "survivors",
                      "affine_instances", "padded_affine_instances",
                      "dropped_send", "dropped_affine", "reverse_best")


def _record_run_metrics(stats: MapperStats) -> None:
    """Mirror one run's ``MapperStats`` into the active registry (no-op
    when metrics are disabled).  Summing these counters across runs is
    ``accumulate_stats`` over the same fields."""
    reg = _metrics.ACTIVE
    if reg is None:
        return
    lab = dict(topology=stats.topology)
    reg.counter("repro_runs_total", **lab).inc()
    for f in _METRIC_RUN_FIELDS:
        v = int(getattr(stats, f))
        if v:
            reg.counter(f"repro_{f}_total", **lab).inc(v)


def totals_from_registry(topology: str, reg=None) -> dict | None:
    """The engine-accounting totals re-derived from the metrics registry
    (None when metrics are disabled).  On a clean run they equal the
    ``accumulate_stats`` totals; under faults the registry counts every
    engine run, retried and bisected blocks included."""
    reg = reg if reg is not None else _metrics.ACTIVE
    if reg is None:
        return None
    return {f: reg.counter(f"repro_{f}_total", topology=topology).value
            for f in _METRIC_RUN_FIELDS}


@dataclasses.dataclass(frozen=True)
class MappingPlan:
    """What a ``Mapper.run`` will execute, decided before any dispatch.

    Single topology: ``chunk`` is the chunk quantum every chunk is padded
    to, ``chunk_sizes`` the real per-chunk read counts, ``lin_cap_max`` /
    ``aff_cap_max`` the ceilings of the measured per-chunk capacities.
    The padded engine runs one unchunked batch of ``chunk`` rows (2n with
    ``both_strands``).

    Mesh topology: ``padded_reads`` is the global batch (reads zero-padded
    up to a multiple of ``n_shards``), ``send_cap`` the per-destination
    send-FIFO capacity of the exchange, and ``stage_b_affine_cap`` the
    per-shard survivor capacity stage B executes.
    """
    topology: str
    engine: str
    n_reads: int
    chunk: int                     # single: chunk quantum; mesh: padded R
    chunk_sizes: tuple
    lin_cap_max: int = 0
    aff_cap_max: int = 0
    n_shards: int = 1
    send_cap: int = 0
    stage_b_affine_cap: int = 0
    padded_reads: int = 0
    both_strands: bool = False

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_sizes)

    @property
    def key(self) -> tuple:
        """Plan-cache key: plans sharing a key share one executable.  The
        mesh key includes the survivor capacity, so a ``stage_b_adaptive``
        session builds a new program exactly when it moves."""
        if self.topology == "mesh":
            return ("mesh", self.padded_reads, self.send_cap,
                    self.stage_b_affine_cap)
        if self.engine == "padded":
            return ("single", "padded", self.n_reads)
        return ("single", self.engine, self.chunk)


def _host_positions(pos):
    """Result-boundary positions: unsigned positions become int64 with
    the all-ones sentinel rewritten to -1 (device positions here are
    int64 already, so they pass through)."""
    if pos is None or pos.dtype.kind != "u":
        return pos
    big = np.iinfo(pos.dtype).max
    out = pos.astype(np.int64)
    out[pos == big] = -1
    return out


def _reduce_strands(res: MappingResult, n: int) -> MappingResult:
    """Fold a stacked fwd-then-rc result of 2n reads to the per-read best:
    lower affine distance wins, ties keep forward; the runner-up is the
    winner strand's second locus or the loser strand's best."""
    rev_wins = res.distance[n:] < res.distance[:n]

    def pick(a):
        if a is None:
            return None
        m = rev_wins.reshape((-1,) + (1,) * (a.ndim - 1))
        return np.where(m, a[n:], a[:n])

    mapped = pick(res.mapped)
    stats = res.stats
    if isinstance(stats, MapperStats):
        stats = dataclasses.replace(
            stats, reads=n, reverse_best=int(np.sum(rev_wins & mapped)),
            extra={**stats.extra, "both_strands": True})
    d2 = None
    if res.distance2 is not None:
        lose_d1 = np.where(rev_wins, res.distance[:n], res.distance[n:])
        d2 = np.minimum(pick(res.distance2), lose_d1).astype(
            res.distance2.dtype)
    return MappingResult(
        position=pick(res.position), distance=pick(res.distance),
        distance2=d2, mapped=mapped, strand=rev_wins.astype(np.int8),
        ops=pick(res.ops), op_count=pick(res.op_count),
        linear_dist=pick(res.linear_dist),
        n_candidates=pick(res.n_candidates), stats=stats)


def check_card_geometry(cfg: MapperConfig, device: torch.device,
                        topology: str = "single") -> None:
    """Refuses, with a ValueError naming the field, a configuration that
    the Hopper WF kernels do not take (``kernels.ops.check_wf_geometry``)
    when ``cfg`` runs them: ``wf_backend="cuda"`` on a CUDA ``device``.
    The fused traceback's bound counts where an engine launches it (not
    the padded engine, not ``cigar_mode="off"``, never on the mesh).
    Elsewhere the plain versions take any geometry, and nothing is
    checked."""
    if device.type == "cuda" and cfg.wf_backend == "cuda":
        ops.check_wf_geometry(cfg.eth, cfg.read_len, cfg.sat_affine,
                              traceback=(topology == "single"
                                         and cfg.engine != "padded"
                                         and cfg.cigar_mode != "off"))


class Mapper:
    """Read-mapping session: placed index + plan cache + executor.

    Parameters
    ----------
    index : GenomeIndex, ShardedGenomeIndex or ShardedIndex
        A flat index of this package (``build_index`` or
        ``GenomeIndex.from_arrays``), placed on the device whole (its
        own tensors, with no copy, where they live there already); or a
        partitioned one (``index.open_index``, ``shard_flat_index``),
        whose chunks are routed through a device arena
        (``index.residency``) and nothing is placed up front.  On
        ``topology="mesh"`` a flat index is sharded across the mesh
        (``core.distributed.shard_index``, on the host: the session keeps
        a host copy, so the card holds only the shards once the caller
        drops an index built there, or hands over ``index.to("cpu")``
        before the shards are placed), partition *i* of a
        ``ShardedGenomeIndex`` is placed on shard *i* (no re-hashing), and
        a ``core.distributed.ShardedIndex`` is placed as it is.
    cfg : MapperConfig, optional
        Defaults to ``MapperConfig.from_index(index)``.
    topology : "single" | "mesh"
        Back-end selection; see the module docstring.
    mesh : core.distributed.ShardMesh, optional
        Mesh topology only.  Defaults to the local form over ``n_shards``
        shards (one when None) on ``device``.
    n_shards, send_cap : int, optional
        Mesh topology only: shard count for the default mesh, and a fixed
        send-FIFO capacity (default: scaled from each plan's batch).
    injector : FaultInjector, optional
        Chaos hook threaded into the streaming engine's fetch thread
        (``core.resilience``); runtime state, not part of the config.
    watchdog_s : float, optional
        Streaming fetch watchdog: a chunk fetch past this wall time
        raises ``streaming.FetchStallError`` instead of hanging the
        session.  None disables the bound.
    device : torch device, optional
        Where the index lives and the stages run (a given ``mesh`` brings
        its own).  None means the CUDA card; with no GPU present that
        raises, and ``device="cpu"`` runs the kernels' plain versions on
        the CPU.  On the card, a geometry the kernels do not take raises
        here (``check_card_geometry``), before the index is placed.
    memory_budget_bytes : int, optional
        Single topology with a sharded index only: the arena's byte budget
        (partitions load lazily and LRU-evict under it); None holds every
        partition.
    prefetch : bool
        Single topology with a sharded index only: stage chunk i+1's
        routing and partition uploads on a background worker while chunk
        i computes (bit-identical results).
    """

    def __init__(self, index, cfg: MapperConfig | None = None, *,
                 topology: str = "single", mesh=None,
                 n_shards: int | None = None, send_cap: int | None = None,
                 device=None, injector=None,
                 watchdog_s: float | None = None,
                 memory_budget_bytes: int | None = None,
                 prefetch: bool = False):
        if topology not in TOPOLOGIES:
            raise ValueError(f"unknown topology {topology!r}; "
                             f"expected one of {TOPOLOGIES}")
        if watchdog_s is not None and watchdog_s <= 0:
            raise ValueError(f"watchdog_s={watchdog_s!r} must be > 0 "
                             f"(or None to disable)")
        from ..index.sharded import ShardedGenomeIndex
        if not isinstance(index, (GenomeIndex, ShardedGenomeIndex,
                                  ShardedIndex)):
            raise NotImplementedError(
                f"mapping over a {type(index).__module__}."
                f"{type(index).__name__}: the port maps its own flat "
                f"GenomeIndex (build_index or GenomeIndex.from_arrays), "
                f"ShardedGenomeIndex (index.open_index or "
                f"index.shard_flat_index) or, on the mesh, ShardedIndex "
                f"(core.distributed.shard_index)")
        self.cfg = cfg or MapperConfig.from_index(index)
        self.topology = topology
        self.send_cap = send_cap
        self.injector = injector
        self.watchdog_s = watchdog_s
        self.part_index = (index if isinstance(index, ShardedGenomeIndex)
                           else None)
        self.router = None
        # rolling per-run stage-B survivor fractions (survivors / bucket
        # entries), fed by _run_mesh; drives adaptive capacity planning
        self._survivor_hist = deque(maxlen=self.cfg.stage_b_history)
        routed = topology == "single" and self.part_index is not None
        if memory_budget_bytes is not None and not routed:
            raise ValueError(
                "memory_budget_bytes only applies to topology=\"single\" "
                "with a repro_torch.index.ShardedGenomeIndex — the mesh "
                "topology places one whole partition per shard, and a flat "
                "GenomeIndex is always fully resident")
        self.prefetch = bool(prefetch)
        if self.prefetch and not routed:
            raise ValueError(
                "prefetch=True only applies to topology=\"single\" with a "
                "repro_torch.index.ShardedGenomeIndex — only the "
                "shard-routed arena path has per-chunk partition uploads to "
                "overlap")
        self._plan_cache: dict[tuple, object] = {}
        self.plan_cache_hits = 0
        self.plan_cache_misses = 0
        self._pool: ThreadPoolExecutor | None = None
        if topology == "mesh":
            self._place_mesh(index, mesh, n_shards, device)
            return
        if isinstance(index, ShardedIndex):
            raise ValueError('topology="single" needs a GenomeIndex, '
                             "not a ShardedIndex")
        self.sharded_index = None
        self.mesh = None
        if self.part_index is not None:
            if self.cfg.engine == "padded":
                raise ValueError(
                    'engine="padded" needs the whole index resident as '
                    "one flat array; use the compacted/fused engines "
                    "with a ShardedGenomeIndex, or "
                    "index.to_genome_index() to flatten it")
            if self.cfg.cigar_mode == "lazy":
                raise ValueError(
                    'cigar_mode="lazy" defers traceback past the run, '
                    "but the residency arena may evict the segment "
                    "rows a deferred traceback would read; use "
                    'cigar_mode="eager" or "off" with a '
                    "ShardedGenomeIndex")
        self.device = resolve_device(device)
        check_card_geometry(self.cfg, self.device)
        if self.part_index is not None:
            from ..index.residency import DeviceResidency, ShardRouter
            self.index = None
            self._dev = None
            self.router = ShardRouter(
                index, DeviceResidency(index, memory_budget_bytes,
                                       device=self.device), self.cfg)
            return
        self.index = index
        # the index's own tensors where they live here already ("cuda" is
        # named as its card first); the span only where there is a copy
        here = torch.empty(0, device=self.device).device
        if all(t.device == here for t in index.tensors):
            self._dev = index.tensors
        else:
            with _tracing.span("index.upload") as sp:
                self._dev = tuple(t.to(self.device) for t in index.tensors)
                if sp:
                    sp.set(bytes=sum(t.nbytes for t in self._dev))

    def _place_mesh(self, index, mesh, n_shards, device) -> None:
        """The mesh branch of the constructor: the mesh (given, or the
        local form on ``device``), the shard count checks, and the local
        shards' index tensors on the mesh's device."""
        if mesh is None:
            mesh = make_genomics_mesh(n_shards, device=device)
        elif (device is not None
              and torch.device(device).type != mesh.device.type):
            raise ValueError(f"device={device!r} but the mesh lives on "
                             f"{mesh.device}")
        self.mesh = mesh
        self.device = mesh.device
        check_card_geometry(self.cfg, self.device, topology="mesh")
        S = mesh.n_shards
        if self.part_index is not None:
            if index.num_partitions != S:
                raise ValueError(
                    f"sharded index has {index.num_partitions} "
                    f"partitions but the mesh has {S} devices — mesh "
                    f"placement maps partition i onto shard i, so "
                    f"rebuild the index with num_partitions={S} or "
                    f"map over a {index.num_partitions}-device mesh")
            sidx = index.to_mesh_shards()
            self.index = None
        elif isinstance(index, ShardedIndex):
            if index.n_shards != S:
                raise ValueError(
                    f"ShardedIndex has {index.n_shards} shards but the "
                    f"mesh has {S} devices")
            sidx = index
            self.index = None
        else:
            # cut on the host, where shard_index works: the session keeps
            # no flat tensors on the card beside the shards
            index = index.to("cpu")
            sidx = shard_index(index, S)
            self.index = index
        self.sharded_index = sidx
        self._dev = sidx.device_arrays(self.device, mesh.local)

    # ------------------------------------------------------------- planning

    def plan(self, reads_spec, *, chunk: int | None = None) -> MappingPlan:
        """The execution plan for a batch (a read count or a reads array).

        ``chunk`` overrides ``cfg.chunk_reads`` for this plan (single
        topology); the mesh's send capacity is the session's ``send_cap``
        or scaled from the batch.  With ``both_strands`` the engine maps
        every read's forward and reverse-complement encodings: each chunk
        carries both (capacities sized for 2*chunk), and the mesh and
        padded engines run one stacked batch of 2n rows."""
        n = (int(reads_spec) if isinstance(reads_spec, (int, np.integer))
             else len(reads_spec))
        cfg = self.cfg
        bs = cfg.both_strands
        eff = 2 * n if bs else n
        if self.topology == "mesh":
            S = self.sharded_index.n_shards
            padded = max(-(-eff // S) * S, S)
            sc = self.send_cap or \
                max(2 * (padded // S) * cfg.max_minis // S, 8)
            return MappingPlan(
                topology="mesh", engine=cfg.engine, n_reads=n,
                chunk=padded, chunk_sizes=(eff,), n_shards=S, send_cap=sc,
                stage_b_affine_cap=stage_b_affine_capacity(
                    S * sc, cfg, frac=self._stage_b_frac()),
                padded_reads=padded, both_strands=bs)
        if cfg.engine == "padded":
            return MappingPlan(topology="single", engine="padded", n_reads=n,
                               chunk=max(eff, 1), chunk_sizes=(eff,),
                               both_strands=bs)
        c = chunk or cfg.chunk_reads or max(n, 1)
        sizes = tuple(min(c, n - i) for i in range(0, n, c))
        rows = 2 * c if bs else c
        return MappingPlan(topology="single", engine=cfg.engine, n_reads=n,
                           chunk=c, chunk_sizes=sizes,
                           lin_cap_max=rows * cfg.max_minis * cfg.max_pls,
                           aff_cap_max=rows * cfg.max_minis, both_strands=bs)

    def _stage_b_frac(self) -> float | None:
        """Adaptive stage-B provisioning fraction, or None for the static
        ``cfg.stage_b_survivor_frac``: the session's rolling quantile of
        observed survivor fractions with 25% headroom, so a workload that
        filters harder than provisioned shrinks the affine pass and one
        that stops filtering grows it instead of dropping survivors."""
        if not self.cfg.stage_b_adaptive or not self._survivor_hist:
            return None
        q = float(np.quantile(np.asarray(self._survivor_hist),
                              self.cfg.stage_b_quantile))
        return min(q * 1.25, 1.0)

    def _executable(self, plan: MappingPlan):
        """Plan-cache lookup, counting hits and misses (in the session and
        in the metrics registry): the chunk pipeline of the compacted and
        fused engines, the padded engine, or the mesh program with its
        survivor capacity."""
        reg = _metrics.ACTIVE
        entry = self._plan_cache.get(plan.key)
        if entry is not None:
            self.plan_cache_hits += 1
            if reg is not None:
                reg.counter("repro_plan_cache_hits_total",
                            topology=self.topology).inc()
            return entry
        self.plan_cache_misses += 1
        if reg is not None:
            reg.counter("repro_plan_cache_misses_total",
                        topology=self.topology).inc()
        if plan.topology == "mesh":
            entry = make_distributed_mapper(
                self.mesh, self.cfg, plan.n_shards, plan.send_cap,
                plan.stage_b_affine_cap)
        elif plan.engine == "padded":
            entry = map_reads_padded
        elif self.router is not None:
            from ..index.residency import _RoutedChunkPipeline
            entry = _RoutedChunkPipeline(self.router, self.cfg, self.device,
                                         prefetch=self.prefetch)
        else:
            entry = _ChunkPipeline(self._dev, self.cfg, self.device)
        self._plan_cache[plan.key] = entry
        return entry

    # ------------------------------------------------------------ execution

    def map(self, reads: np.ndarray) -> MappingResult:
        """Plan + run one read batch."""
        reads = np.asarray(reads)
        return self.run(self.plan(len(reads)), reads)

    def map_pairs(self, reads1: np.ndarray, reads2: np.ndarray,
                  ) -> tuple[MappingResult, MappingResult]:
        """Map both mates of a paired batch in ONE stacked engine batch.

        ``reads1[i]`` and ``reads2[i]`` are the R1/R2 mates of pair
        ``i``, each in as-sequenced orientation (both_strands handles
        orientation per mate).  The stack shares a single plan — same
        chunking, same capacities, one strand reduce — and is split back
        into per-mate results, so pairing never forks the execution
        path.  Pair resolution (proper pairs, rescue, MAPQ) lives in
        ``repro_torch.core.pairing``.
        """
        reads1, reads2 = np.asarray(reads1), np.asarray(reads2)
        if reads1.shape != reads2.shape:
            raise ValueError(f"mate batches must align pairwise: "
                             f"{reads1.shape} vs {reads2.shape}")
        res = self.map(np.concatenate([reads1, reads2]))
        return split_result(res, len(reads1))

    def serve(self, batcher=None, **kwargs):
        """A ``MappingService`` request batcher wired to this session.
        ``kwargs`` forward to ``MappingService`` (``admission=``,
        ``retry=``, ``injector=``)."""
        from .serving import BatcherConfig, MappingService
        return MappingService(self, batcher=batcher or BatcherConfig(),
                              **kwargs)

    def with_config(self, cfg: MapperConfig) -> "Mapper":
        """A session running ``cfg`` on this one's device, placed index
        (or residency arena: a new router over the same arena, so its
        budget; or mesh, its shards and ``send_cap``), injector, watchdog
        and prefetch, with a plan cache and survivor history of its own —
        the resilience layer's fallback rungs."""
        check_card_geometry(cfg, self.device, topology=self.topology)
        m = copy.copy(self)
        m.cfg = cfg
        m._plan_cache = {}
        m.plan_cache_hits = m.plan_cache_misses = 0
        m._pool = None
        m._survivor_hist = deque(maxlen=cfg.stage_b_history)
        if self.router is not None:
            from ..index.residency import ShardRouter
            m.router = ShardRouter(self.part_index, self.router.residency,
                                   cfg)
        return m

    def map_async(self, reads: np.ndarray) -> Future:
        """Submit a batch to the session worker thread; returns a Future
        of the ``MappingResult``.  Submissions run in order."""
        reads = np.asarray(reads)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mapper-session")
        return self._pool.submit(self.map, reads)

    def index_storage(self) -> dict | None:
        """Footprint accounting of the session's index: the flat
        ``storage_bytes`` dict, or the sharded one with its
        ``per_partition`` breakdown.  None when the session holds only a
        ``ShardedIndex``, with no host-side source index."""
        src = self.part_index if self.part_index is not None else self.index
        if src is None:
            return None
        return src.storage_bytes()

    def close(self):
        """Shut down the ``map_async`` worker and any arena prefetch
        worker (no-op if never used)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        for entry in self._plan_cache.values():
            if hasattr(entry, "close"):
                entry.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def run(self, plan: MappingPlan, reads: np.ndarray) -> MappingResult:
        """Execute ``reads`` through ``plan``'s cached executable.

        ``len(reads)`` may be smaller than the plan's batch: chunks are
        padded to the plan's quantum and results trimmed.  On a
        ``both_strands`` plan every chunk maps its reads' forward and
        reverse-complement encodings and folds them on the device; the
        padded engine and the mesh map one stacked fwd-then-rc batch and
        reduce it on the host (``_reduce_strands``), with the same result.

        Where spans record, the call is one ``mapper.run`` span whose id
        is the ``call`` of every span recorded under it.
        """
        reads = np.asarray(reads)
        with _tracing.span("mapper.run") as sp:
            if sp is not None:
                sp.scope(call=sp.sid)
                sp.set(reads=len(reads), engine=self.cfg.engine,
                       topology=plan.topology)
            if plan.topology == "mesh" or plan.engine == "padded":
                one = (self._run_mesh if plan.topology == "mesh"
                       else self._run_padded)
                if not plan.both_strands:
                    return one(plan, reads)
                n_real = len(reads)
                res = one(plan, np.concatenate([reads, revcomp(reads)]))
                return _reduce_strands(res, n_real)
            return self._run_chunks(plan, reads)

    def _run_chunks(self, plan: MappingPlan,
                    reads: np.ndarray) -> MappingResult:
        """The compacted and fused engines: the plan's chunks through the
        chunk pipeline, streamed or synchronous, each chunk's fetch
        writing its rows of the call's own result arrays; then the stats
        assembled on the host (the ``assemble`` span, whose ``bytes`` are
        the result bytes it copies: none)."""
        n = len(reads)
        cfg = self.cfg
        pipe = self._executable(plan)
        items = [(reads[c0 : c0 + plan.chunk], plan.chunk)
                 for c0 in range(0, n, plan.chunk)]
        into = _CallArrays(n)
        fetch = functools.partial(pipe.fetch, into=into)
        times = {} if (cfg.profile or not cfg.stream) else None
        pipe.begin_run(items, times)
        if cfg.stream:
            fetched = streaming.stream_map(items, pipe.phase1, pipe.phase2,
                                           fetch, times=times,
                                           injector=self.injector,
                                           watchdog_s=self.watchdog_s)
        else:
            fetched = streaming.sync_map(items, pipe.phase1, pipe.phase2,
                                         fetch, times=times)
        with _tracing.span("assemble") as sp:
            raw = _merge_stats(fetched)
            raw["stream"] = cfg.stream
            if cfg.both_strands:
                raw["both_strands"] = True
            if times is not None:
                raw["stage_times_s"] = dict(times)
            if self.router is not None:
                raw["partitions"] = self.router.drain_stats()
            arr = into.arrays
            position = _host_positions(arr.get("position"))
            if sp is not None:
                sp.set(bytes=0 if position is arr.get("position")
                       else position.nbytes)
            mapped = arr.get("mapped")
            lazy = None
            if cfg.cigar_mode == "lazy":
                lazy = LazyTraceback(self._dev[3], cfg, arr["_tb_reads"],
                                     arr["_tb_occ"], arr["_tb_mpos"], mapped)
            stats = MapperStats(
                topology="single", engine=cfg.engine, reads=n,
                candidates=raw["candidates_valid"],
                survivors=raw["survivors"],
                affine_instances=raw["affine_dist_instances"],
                padded_affine_instances=raw["padded_affine_instances"],
                reverse_best=raw.get("reverse_best", 0),
                plan_cache_hits=self.plan_cache_hits,
                plan_cache_misses=self.plan_cache_misses, extra=raw)
            _record_run_metrics(stats)
            return MappingResult(position=position,
                                 distance=arr.get("distance"),
                                 distance2=arr.get("distance2"),
                                 mapped=mapped, strand=arr.get("strand"),
                                 ops=arr.get("ops"),
                                 op_count=arr.get("op_count"),
                                 linear_dist=arr.get("linear_dist"),
                                 n_candidates=arr.get("n_candidates"),
                                 stats=stats, lazy_tb=lazy)

    def _run_padded(self, plan: MappingPlan,
                    reads: np.ndarray) -> MappingResult:
        """One batch through the padded engine; ``stats`` is None, as on
        the reference's padded engine."""
        fn = self._executable(plan)
        dev_reads = torch.from_numpy(
            np.ascontiguousarray(reads, dtype=np.uint8)).to(self.device)
        out = fn(*self._dev, dev_reads, self.cfg)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        return MappingResult(position=host["position"],
                             distance=host["distance"],
                             distance2=host["distance2"],
                             mapped=host["mapped"], ops=host["ops"],
                             op_count=host["op_count"],
                             linear_dist=host["linear_dist"],
                             n_candidates=host["n_candidates"], stats=None)

    def _run_mesh(self, plan: MappingPlan, reads: np.ndarray,
                  ) -> MappingResult:
        """One batch through the mesh program: padded to the plan's batch,
        each local shard's rows to the mesh's device, results trimmed.
        ``stage_times_s`` holds the two host-visible boundaries, the
        ``dispatch`` and ``d2h`` stage spans (where ``profile`` is set or
        a tracer armed)."""
        n = len(reads)
        fn, aff_cap = self._executable(plan)
        if n > plan.padded_reads:
            raise ValueError(f"{n} reads exceed the plan's padded batch "
                             f"shape {plan.padded_reads}; re-plan")
        if n < plan.padded_reads:
            pad = np.zeros((plan.padded_reads - n, reads.shape[1]),
                           reads.dtype)
            reads = np.concatenate([reads, pad])
        S = plan.n_shards
        r_local = plan.padded_reads // S
        local = self.mesh.local
        if len(local) < S:                  # the group form: own rows only
            reads = np.concatenate([reads[s * r_local:(s + 1) * r_local]
                                    for s in local])
        times = ({} if (self.cfg.profile or _tracing.ACTIVE is not None)
                 else None)
        with _tracing.span("dispatch", times):
            dev_reads = torch.from_numpy(np.ascontiguousarray(
                reads, dtype=np.uint8)).to(self.device)
            outs = fn(*self._dev, dev_reads)
        with _tracing.span("d2h", times) as sp:
            host = [t.cpu() for t in outs]
            if sp is not None:
                _copy_args(sp, host)
            pos, dist, dist2, dropped, n_surv, aff_drop = (
                t.numpy() for t in host)
            pos, dist, dist2 = pos[:n], dist[:n], dist2[:n]
        surv = int(n_surv.sum())
        n_aff_drop = int(aff_drop.sum())
        entries = S * S * plan.send_cap
        self._survivor_hist.append(surv / max(entries, 1))
        raw = dict(stage_b_entries=entries, stage_b_survivors=surv,
                   stage_b_affine_capacity=aff_cap,
                   stage_b_affine_instances=S * aff_cap,
                   stage_b_padded_affine_instances=entries,
                   stage_b_affine_dropped=n_aff_drop,
                   send_dropped=int(dropped.sum()),
                   send_dropped_per_shard=dropped,
                   stage_b_survivors_per_shard=n_surv,
                   padded_reads=plan.padded_reads)
        if times is not None:
            raw["stage_times_s"] = dict(times)
        if self.part_index is not None:
            # partition i IS shard i: per-shard counters are per-partition
            raw["partitions"] = dict(
                num_partitions=S,
                occurrences_per_partition=[p.n_occurrences
                                           for p in self.part_index.parts],
                survivors_per_partition=n_surv.tolist())
        stats = MapperStats(
            topology="mesh", engine=self.cfg.engine, reads=n,
            candidates=entries, survivors=surv,
            affine_instances=S * aff_cap, padded_affine_instances=entries,
            dropped_send=int(dropped.sum()), dropped_affine=n_aff_drop,
            plan_cache_hits=self.plan_cache_hits,
            plan_cache_misses=self.plan_cache_misses, extra=raw)
        _record_run_metrics(stats)
        return MappingResult(position=pos, distance=dist, distance2=dist2,
                             mapped=pos >= 0, stats=stats)
