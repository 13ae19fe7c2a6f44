"""Request batching for the mapping service (the serving front-end) —
torch twin of ``repro.core.serving``.

A mapping service receives read batches of arbitrary size — per-client
FASTQ slices, not the engine's chunk shape.  ``ReadBatcher`` is the
Reads-FIFO analog at the request layer: it coalesces pending requests
into **power-of-two bucket shapes** between ``bucket_min`` and
``bucket_max`` (the streaming engine's chunk size), so

  * the session's plan cache holds at most
    ``log2(bucket_max / bucket_min) + 1`` entries, regardless of the
    request-size distribution;
  * full ``bucket_max`` buckets flow through the streaming engine
    back-to-back (one multi-chunk streamed run);
  * the residue pays at most 2x padding on the *last* bucket only.

``MappingService`` wraps the batcher + a ``repro_torch.core.mapper.Mapper``
session with per-request result reassembly and padding/throughput
accounting.  On the single topology full buckets run as one streamed
multi-chunk plan and the residue as its own pow-2 chunk shape; on the
mesh every bucket is one distributed batch planned at its bucket size,
so same-size buckets share one plan-cache entry.

Fault tolerance (``repro_torch.core.resilience``): admission control
bounds the pending queue at ``submit`` (``AdmissionConfig`` — block or
shed, plus per-request deadlines), and ``flush`` is **transactional**:
every drained request id is resolved exactly once, to its results or to
a structured ``MappingError`` — a failed bucket is retried, bisected and
quarantined by the ``ResilientMapper`` so it takes down only the reads
that caused it, never the flush.  The kernels' own errors are the
exception: they raise out of ``flush`` (``core.resilience``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..obs import registry as _metrics
from .compaction import bucket_capacity
from .mapper import (_PER_READ_FIELDS, Mapper, accumulate_partition_stats,
                     accumulate_stats, split_result)
from .pipeline import MapperConfig, MappingResult
from .resilience import (_KERNEL_ERRORS, AdmissionConfig, MappingError,
                         ResilientMapper, RetryPolicy, ShedError,
                         assemble_segments)


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    bucket_min: int = 64     # smallest bucket shape (pow2)
    bucket_max: int = 1024   # largest; == the streaming chunk size (pow2)

    def __post_init__(self):
        for name in ("bucket_min", "bucket_max"):
            v = getattr(self, name)
            if v < 1 or (v & (v - 1)) != 0:
                raise ValueError(f"{name}={v!r} must be a positive power "
                                 f"of two")
        if self.bucket_min > self.bucket_max:
            raise ValueError(f"bucket_min={self.bucket_min} must be <= "
                             f"bucket_max={self.bucket_max}")


def pow2_buckets(n: int, *, lo: int, hi: int) -> list[int]:
    """Greedy cover of ``n`` reads by pow-2 bucket sizes in ``[lo, hi]``:
    full ``hi`` buckets first, one rounded-up bucket for the residue."""
    out = [hi] * (n // hi)
    rest = n % hi
    if rest:
        out.append(bucket_capacity(rest, align=lo, cap_max=hi))
    return out


class ReadBatcher:
    """Coalesce variable-sized incoming read batches into pow-2 buckets.

    ``submit`` enqueues a request and returns its id; ``drain`` hands back
    everything pending as one concatenated read block plus the bucket
    cover and per-request spans, and resets the queue.

    ``stats`` is safe for long-lived serving: the counters are scalars and
    ``bucket_hist`` is keyed by bucket size — a power of two in
    ``[bucket_min, bucket_max]`` — so it holds at most
    ``log2(bucket_max / bucket_min) + 1`` entries no matter how many
    requests pass through.

    Malformed submissions raise ``ValueError`` (not ``assert`` — service
    callers need recoverable errors, and asserts vanish under
    ``python -O``).
    """

    def __init__(self, read_len: int, cfg: BatcherConfig = BatcherConfig()):
        self.read_len = read_len
        self.cfg = cfg
        self._pending: list[tuple[int, np.ndarray]] = []
        self._next_id = 0
        self.stats = dict(requests=0, reads=0, padded_reads=0,
                          bucket_hist={})

    @property
    def pending_reads(self) -> int:
        return sum(len(r) for _, r in self._pending)

    def submit(self, reads: np.ndarray) -> int:
        reads = np.asarray(reads)
        if reads.ndim != 2 or reads.shape[1] != self.read_len:
            raise ValueError(f"expected (n, {self.read_len}) reads, got "
                             f"{reads.shape}")
        # empty requests are rejected up front: an all-empty flush would
        # otherwise drain the queue without ever resolving their ids
        if len(reads) < 1:
            raise ValueError("empty read batch")
        rid = self._next_id
        self._next_id += 1
        self._pending.append((rid, reads))
        self.stats["requests"] += 1
        self.stats["reads"] += len(reads)
        return rid

    def drain(self):
        """-> (reads (N, rl), buckets [sizes], spans {rid: (lo, hi)})."""
        if not self._pending:
            return (np.zeros((0, self.read_len), np.uint8), [], {})
        spans, off = {}, 0
        for rid, r in self._pending:
            spans[rid] = (off, off + len(r))
            off += len(r)
        reads = np.concatenate([r for _, r in self._pending])
        self._pending = []
        buckets = pow2_buckets(len(reads), lo=self.cfg.bucket_min,
                               hi=self.cfg.bucket_max)
        self.stats["padded_reads"] += sum(buckets) - len(reads)
        for b in buckets:
            hist = self.stats["bucket_hist"]
            hist[b] = hist.get(b, 0) + 1
        return reads, buckets, spans


# the per-read MappingResult fields, shared with mapper.split_result so
# reassembly and pair splitting cannot drift apart
_RESULT_FIELDS = _PER_READ_FIELDS

# engine accounting accumulated from each flush's merged MapperStats ...
_TOTAL_FIELDS = ("reads", "candidates", "survivors", "affine_instances",
                 "padded_affine_instances", "dropped_send", "dropped_affine",
                 "reverse_best")
# ... plus the service-level failure counters maintained by the service
# itself (these are NOT MapperStats attributes — _accumulate must keep
# passing fields=_TOTAL_FIELDS explicitly)
_SERVICE_FIELDS = ("shed_requests", "deadline_misses", "retries",
                   "failed_reads", "failed_requests")

# distinct tenant label values tracked per service; extra tenants share a
# single "_other" bucket so the depth gauges (and the registry label sets
# behind them) stay bounded under long-lived serving
_MAX_TENANTS = 64


class MappingService:
    """Mapping service: request batcher + a ``Mapper`` session.

    Construct from an existing session (``MappingService(mapper)`` /
    ``mapper.serve()``) or from an index + config (+ ``device=``), which
    builds a single-topology session internally.

    ``submit`` queues a request; ``flush`` drains the batcher, routes the
    coalesced buckets through the session (see the module docstring) and
    returns ``{request_id: MappingResult}``.
    ``totals`` accumulates the unified ``MapperStats`` accounting across
    flushes — survivors, executed affine instances, drop counters — and
    ``mapper.plan_cache_hits``/``misses`` expose the warm-up behaviour.

    Fault-tolerance knobs:

    admission : AdmissionConfig
        Bounded pending queue + default deadline.  When a ``submit``
        would push ``pending_reads`` past ``max_pending_reads``:
        ``policy="block"`` flushes the queue synchronously first (those
        results are delivered by the *next* ``flush``) and then accepts;
        ``policy="shed"`` raises ``ShedError`` and counts
        ``totals["shed_requests"]``.  A single request larger than the
        bound is accepted against an empty queue (no livelock).
    retry : RetryPolicy
        Block-level retry/bisection/degradation applied inside ``flush``
        (see ``resilience.ResilientMapper``).
    injector : FaultInjector
        Chaos hook: armed sites fire inside ``flush`` and in the
        session's streaming fetch thread.

    ``flush`` resolves **every** drained request id exactly once — to a
    ``MappingResult`` (possibly carrying a partial ``failed`` quarantine
    mask), a ``(res1, res2)`` pair, or a ``MappingError`` — even when a
    bucket, the injector, or the service itself fails mid-flush; a
    kernel's own error raises instead (``core.resilience``).
    """

    def __init__(self, index_or_mapper, cfg: MapperConfig | None = None,
                 batcher: BatcherConfig = BatcherConfig(), *,
                 admission: AdmissionConfig = AdmissionConfig(),
                 retry: RetryPolicy = RetryPolicy(), injector=None,
                 device=None):
        if isinstance(index_or_mapper, Mapper):
            if cfg is not None or device is not None:
                raise ValueError("pass cfg and device via the Mapper "
                                 "session")
            self.mapper = index_or_mapper
        else:
            self.mapper = Mapper(index_or_mapper, cfg, injector=injector,
                                 device=device)
        self.index = self.mapper.index
        self.cfg = self.mapper.cfg
        self.batcher = ReadBatcher(self.cfg.read_len, batcher)
        self.admission = admission
        self.injector = injector if injector is not None \
            else self.mapper.injector
        self.resilient = ResilientMapper(self.mapper, retry,
                                         injector=self.injector)
        self.totals = {k: 0 for k in _TOTAL_FIELDS + _SERVICE_FIELDS}
        self._paired: set[int] = set()
        self._deadlines: dict[int, float] = {}
        self._ready: dict[int, object] = {}
        # per-request observability state, drained with the request: both
        # dicts are keyed by pending rids only, so they are bounded by the
        # admission queue, and the tenant label space is capped at
        # _MAX_TENANTS (+ "_other")
        self._submit_ts: dict[int, float] = {}
        self._tenants: dict[int, str] = {}
        self._tenant_pending: dict[str, int] = {}

    # ----------------------------------------------------------- admission

    def _admit(self, n_reads: int) -> None:
        lim = self.admission.max_pending_reads
        if lim is None:
            return
        pending = self.batcher.pending_reads
        if pending + n_reads <= lim or pending == 0:
            return  # fits, or single oversize request against empty queue
        if self.admission.policy == "shed":
            self.totals["shed_requests"] += 1
            reg = _metrics.ACTIVE
            if reg is not None:
                reg.counter("repro_shed_requests_total").inc()
            raise ShedError(
                f"pending queue full ({pending} + {n_reads} > {lim} "
                f"reads); resubmit after a flush")
        # "block": drain synchronously, hold results for the next flush.
        # flush() swaps self._ready for a fresh dict, so the held results
        # must be merged into the *post*-flush dict, not the pre-flush one
        held = self.flush()
        self._ready.update(held)

    def _arm_deadline(self, rid: int, deadline_s: float | None) -> int:
        dl = deadline_s if deadline_s is not None \
            else self.admission.deadline_s
        if dl is not None:
            if dl <= 0:
                raise ValueError(f"deadline_s={dl!r} must be > 0")
            self._deadlines[rid] = time.monotonic() + dl
        return rid

    # ---------------------------------------------------------- submission

    def submit(self, reads: np.ndarray, *,
               deadline_s: float | None = None,
               tenant: str | None = None) -> int:
        reads = np.asarray(reads)
        self._admit(len(reads))
        rid = self._arm_deadline(self.batcher.submit(reads), deadline_s)
        self._track_submit(rid, tenant)
        return rid

    def submit_paired(self, reads1: np.ndarray, reads2: np.ndarray, *,
                      deadline_s: float | None = None,
                      tenant: str | None = None) -> int:
        """Queue a paired-end request: mates ride the bucket pipeline as
        one stacked block (R1 rows then R2 rows), and ``flush`` hands the
        request back as a ``(res1, res2)`` per-mate tuple instead of one
        ``MappingResult`` — the serving-layer face of
        ``Mapper.map_pairs``."""
        reads1, reads2 = np.asarray(reads1), np.asarray(reads2)
        if reads1.shape != reads2.shape:
            raise ValueError(f"mate batches must align pairwise: "
                             f"{reads1.shape} vs {reads2.shape}")
        self._admit(2 * len(reads1))
        rid = self.batcher.submit(np.concatenate([reads1, reads2]))
        self._paired.add(rid)
        rid = self._arm_deadline(rid, deadline_s)
        self._track_submit(rid, tenant)
        return rid

    # ------------------------------------------------- per-request tracking

    def _tenant_key(self, tenant: str | None) -> str:
        t = tenant if tenant is not None else "default"
        if t in self._tenant_pending or len(self._tenant_pending) \
                < _MAX_TENANTS:
            return t
        return "_other"

    def _track_submit(self, rid: int, tenant: str | None) -> None:
        self._submit_ts[rid] = time.perf_counter()
        t = self._tenant_key(tenant)
        self._tenants[rid] = t
        depth = self._tenant_pending.get(t, 0) + 1
        self._tenant_pending[t] = depth
        reg = _metrics.ACTIVE
        if reg is not None:
            reg.counter("repro_requests_total", tenant=t).inc()
            reg.gauge("repro_tenant_queue_depth", tenant=t).set(depth)

    def _drain_tracking(self, spans) -> None:
        """Close out per-request tracking for every drained rid: observe
        queue-wait latency and decrement the owning tenant's depth."""
        now = time.perf_counter()
        reg = _metrics.ACTIVE
        for rid in spans:
            ts = self._submit_ts.pop(rid, None)
            if ts is not None and reg is not None:
                reg.histogram(
                    "repro_request_queue_wait_seconds").observe(now - ts)
            t = self._tenants.pop(rid, None)
            if t is not None:
                depth = max(self._tenant_pending.get(t, 1) - 1, 0)
                self._tenant_pending[t] = depth
                if reg is not None:
                    reg.gauge("repro_tenant_queue_depth",
                              tenant=t).set(depth)

    @property
    def tenant_queue_depth(self) -> dict[str, int]:
        """Pending request count per tenant label (bounded at
        ``_MAX_TENANTS`` distinct tenants plus ``"_other"``)."""
        return {t: d for t, d in self._tenant_pending.items() if d}

    def _accumulate(self, stats) -> None:
        accumulate_stats(self.totals, stats, fields=_TOTAL_FIELDS)
        accumulate_partition_stats(self.totals, stats)

    # --------------------------------------------------------------- flush

    def flush(self) -> dict[int, object]:
        """Drain and map everything pending.

        Returns ``{request_id: MappingResult | (res1, res2) |
        MappingError}`` covering every id drained by this call (plus any
        results held from admission-triggered blocking flushes).  The
        resolve is transactional: ids are removed from the pending state
        *first*, then each is resolved exactly once — a failure anywhere
        in the mapping path turns into per-request ``MappingError``
        values, never a raise that would strand drained ids.
        """
        t0 = time.perf_counter()
        try:
            return self._flush()
        finally:
            reg = _metrics.ACTIVE
            if reg is not None:
                reg.histogram("repro_flush_seconds").observe(
                    time.perf_counter() - t0)

    def _flush(self) -> dict[int, object]:
        out, self._ready = self._ready, {}
        reads, buckets, spans = self.batcher.drain()
        self._drain_tracking(spans)
        if not buckets:
            return out
        paired = {rid for rid in spans if rid in self._paired}
        self._paired -= paired      # moved out of pending state at drain

        # expire deadlines before spending any compute on the batch
        now = time.monotonic()
        live: list[tuple[int, np.ndarray]] = []
        for rid, (lo, hi_) in spans.items():
            dl = self._deadlines.pop(rid, None)
            if dl is not None and now > dl:
                self.totals["deadline_misses"] += 1
                reg = _metrics.ACTIVE
                if reg is not None:
                    reg.counter("repro_deadline_misses_total").inc()
                out[rid] = MappingError(
                    "deadline", f"request {rid} missed its deadline by "
                    f"{now - dl:.3f}s before mapping", n_reads=hi_ - lo)
            else:
                live.append((rid, reads[lo:hi_]))
        if not live:
            return out
        if len(live) < len(spans):  # rebuild the batch without the expired
            spans, off = {}, 0
            for rid, r in live:
                spans[rid] = (off, off + len(r))
                off += len(r)
            reads = np.concatenate([r for _, r in live])
            buckets = pow2_buckets(len(reads), lo=self.batcher.cfg.bucket_min,
                                   hi=self.batcher.cfg.bucket_max)
        else:
            spans = {rid: spans[rid] for rid, _ in live}

        try:
            if self.injector is not None:
                self.injector.check("flush")
            segments, counters = self._map_buckets(reads, buckets)
            res, mask = assemble_segments(segments, self.resilient.cfg,
                                          counters)
            self.totals["retries"] += counters["retries"]
            self.totals["failed_reads"] += counters["failed_reads"]
            if res is not None:
                self._accumulate(res.stats)
            for rid, (lo, hi_) in spans.items():
                out[rid] = self._resolve(res, mask, lo, hi_,
                                         paired=rid in paired)
        except _KERNEL_ERRORS:
            raise
        except Exception as e:  # noqa: BLE001 — transactional boundary:
            # every drained id must resolve; an unexpected failure here
            # becomes a structured per-request error, not a stranded rid
            for rid, (lo, hi_) in spans.items():
                if rid not in out:
                    self.totals["failed_requests"] += 1
                    reg = _metrics.ACTIVE
                    if reg is not None:
                        reg.counter("repro_failed_requests_total").inc()
                    out[rid] = MappingError(
                        "internal", f"{type(e).__name__}: {e}",
                        n_reads=hi_ - lo)
        return out

    def _map_buckets(self, reads: np.ndarray, buckets: list[int]):
        """Route the bucket cover through the resilient mapper ->
        ``(segments, counters)`` covering ``reads`` in order."""
        counters = None
        segments = []

        def timed_map(*a, **kw):
            t0 = time.perf_counter()
            try:
                return self.resilient.map_segments(*a, **kw)
            finally:
                reg = _metrics.ACTIVE
                if reg is not None:
                    reg.histogram("repro_bucket_execute_seconds").observe(
                        time.perf_counter() - t0)

        if self.mapper.topology == "mesh":
            # every bucket is one distributed batch; same-size buckets
            # share a plan key, so one mesh program
            off = 0
            for b in buckets:
                block = reads[off : off + b]  # last block may be short
                seg, counters = timed_map(
                    block, plan_n=b, base=off, counters=counters)
                segments += seg
                off += b
            return segments, counters
        hi = self.batcher.cfg.bucket_max
        n_full = sum(1 for b in buckets if b == hi)
        if n_full:  # full buckets: one streamed multi-chunk plan
            seg, counters = timed_map(
                reads[: n_full * hi], chunk=hi, counters=counters)
            segments += seg
        rest = reads[n_full * hi :]
        if len(rest):  # residue: its own pow-2 chunk shape
            seg, counters = timed_map(
                rest, chunk=buckets[-1], base=n_full * hi,
                counters=counters)
            segments += seg
        return segments, counters

    def _resolve(self, res, mask, lo, hi_, *, paired: bool):
        """One request's slice of the assembled flush result."""
        n = hi_ - lo
        if res is None or mask[lo:hi_].all():
            self.totals["failed_requests"] += 1
            reg = _metrics.ACTIVE
            if reg is not None:
                reg.counter("repro_failed_requests_total").inc()
            return MappingError("execution",
                                "all reads in this request were "
                                "quarantined after retries", n_reads=n)

        def raw(f):
            # raw access: a cigar_mode="lazy" flush result must not be
            # materialized just to be reassembled per request
            v = object.__getattribute__(res, f)
            return v[lo:hi_] if v is not None else None

        lt = object.__getattribute__(res, "lazy_tb")
        part = MappingResult(**{f: raw(f) for f in _RESULT_FIELDS},
                             stats=None,
                             lazy_tb=lt[lo:hi_] if lt is not None else None)
        if paired:
            return split_result(part, n // 2)
        return part

    @property
    def affine_drop_rate(self) -> float:
        """Fraction of stage-B filter survivors dropped on affine-capacity
        overflow, across all flushes so far (0.0 on the single topology,
        which never drops)."""
        return self.totals["dropped_affine"] / max(self.totals["survivors"],
                                                   1)
