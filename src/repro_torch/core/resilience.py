"""Fault tolerance for the mapping service (the always-on posture) — torch
twin of ``repro.core.resilience``.

DART-PIM is pitched as an always-on end-to-end accelerator; a real
deployment keeps mapping throughput up despite defective ranks, stalled
controllers and malformed real-world reads.  On the card the failure
surface is the same shape — a wedged fetch thread, a device error or
capacity blow-up in one bucket, a poisoned read that reliably kills its
chunk — and the posture is the same: **contain the failure to the work
that caused it** and keep the rest of the stream flowing.  This module is
the one home of that policy layer:

``MappingError``
    The structured per-request failure result.  A bucket that exhausts
    its retries resolves the affected request(s) to one of these instead
    of raising through ``MappingService.flush``.
``RetryPolicy``
    Exponential-backoff retry + chunk bisection: a failed block is
    retried, then split in half and each half mapped independently, so a
    single poisoned read quarantines ``bisect_min`` reads, not the whole
    bucket.
``AdmissionConfig``
    Backpressure at ``MappingService.submit``: a bounded pending-reads
    queue with ``block`` (drain synchronously) or ``shed`` (reject with
    ``ShedError``) overflow policies, plus per-request deadlines.
``DegradeLadder``
    Graceful degradation after repeated failures: ``fused -> compacted``
    engine.  The backend never steps down: the reference's third rung
    (``pallas -> jnp``) would run the kernels' plain versions on the card
    and hide the kernels.  A rung's session is ``Mapper.with_config`` of
    the base session: the same device and placed index, arena, or mesh
    and ``send_cap``.  Sticky by design — a session that had to degrade
    stays degraded until rebuilt.  Every step down is counted and written
    to stderr.
``FaultInjector``
    The deterministic chaos hook threaded through
    ``streaming.stream_map`` (fetch stalls/errors), the bucket executor
    (transient kills, poisoned rows, engine-targeted failures) and the
    FASTQ parser (record corruption).  Same seed, same faults — every
    chaos test is reproducible.
``ResilientMapper``
    A ``Mapper`` wrapper applying retry/bisect/degrade, returning
    per-read results with a ``failed`` quarantine mask instead of
    raising.

The containment boundary stops at the kernels.  A card session that a
``ResilientMapper`` wraps builds and loads its kernel libraries when the
wrapper is built, outside any ``try``, so a compile failure raises, and
a torch without ``torch.AcceleratorError`` is refused there (its CUDA
errors are plain ``RuntimeError``s the boundary could not tell apart).  A
kernel launch error (``ops.KernelLaunchError``), a failed build
(``build.KernelBuildError``) and a CUDA error torch reports
(``torch.AcceleratorError``) are re-raised from ``map_segments``, never
retried, bisected or degraded around: a CUDA error can leave the context
unusable, so neither a retry nor the plain versions on the same device
could be trusted, and a fallback would hide the kernel's fault.

Import discipline: this module may import ``mapper``/``pipeline`` (they
never import it back); ``streaming`` stays below it and defines its own
``FetchStallError``.
"""
from __future__ import annotations

import dataclasses
import sys
import time
import zlib

import numpy as np
import torch

from ..kernels import build as _kbuild
from ..kernels import ops as _ops
from ..obs import registry as _metrics
from .encoding import OP_NONE
from .mapper import _PER_READ_FIELDS, Mapper, MapperStats
from .pipeline import LazyTraceback, MapperConfig, MappingResult
from .streaming import FetchStallError  # noqa: F401  (re-export: the
#                       public error taxonomy lives in this module)

__all__ = ["MappingError", "RetryPolicy", "AdmissionConfig",
           "DegradeLadder", "FaultInjector", "ResilientMapper",
           "InjectedFault", "ShedError", "FetchStallError"]


# errors the containment boundary re-raises: the kernels' own faults
_KERNEL_ERRORS = (_ops.KernelLaunchError, _kbuild.KernelBuildError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())


def _obs_inc(name: str, n=1) -> None:
    """Bump a resilience counter in the active metrics registry (no-op
    when metrics are disabled)."""
    reg = _metrics.ACTIVE
    if reg is not None:
        reg.counter(name).inc(n)


class InjectedFault(RuntimeError):
    """A deterministic fault raised by ``FaultInjector`` (chaos tests)."""


class ShedError(RuntimeError):
    """``MappingService.submit`` rejected a request: the pending queue is
    full and the admission policy is ``shed``.  Recoverable — resubmit
    after a ``flush``."""


@dataclasses.dataclass(frozen=True)
class MappingError:
    """Structured per-request failure result.

    ``MappingService.flush`` resolves a request to one of these — instead
    of raising and losing every other request in the drain — when its
    reads could not be mapped: every read failed after retries and
    bisection, the request's deadline expired before mapping, or the
    flush itself hit an unexpected error.  ``error_type`` is the stable
    taxonomy key (``"execution"`` | ``"deadline"`` | ``"internal"``);
    ``message`` carries the underlying cause.
    """
    error_type: str
    message: str
    n_reads: int = 0
    attempts: int = 0

    @property
    def ok(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Error isolation for one mapped block (bucket/chunk).

    A failing block is retried ``max_attempts`` times with exponential
    backoff (``backoff_s * backoff_mult**attempt`` seconds between
    attempts; set ``backoff_s=0`` in tests).  A block that exhausts its
    attempts is split in half and each half mapped independently
    (recursively), so a persistent failure — a poisoned read that
    reliably kills its chunk — is quarantined down to a block of at most
    ``bisect_min`` reads while every healthy read still maps.
    ``degrade_after`` consecutive block-level failures step the
    ``DegradeLadder`` (``fused -> compacted`` engine).
    """
    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    bisect_min: int = 16
    degrade_after: int = 2

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts={self.max_attempts!r} must "
                             f"be >= 1")
        if self.backoff_s < 0 or self.backoff_mult < 1.0:
            raise ValueError("backoff_s must be >= 0 and backoff_mult >= 1")
        if self.bisect_min < 1:
            raise ValueError(f"bisect_min={self.bisect_min!r} must be >= 1")
        if self.degrade_after < 1:
            raise ValueError(f"degrade_after={self.degrade_after!r} must "
                             f"be >= 1")


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission control at ``MappingService.submit``.

    ``max_pending_reads`` bounds the batcher queue (None = unbounded).
    When a submit would overflow it, ``policy`` decides:

    * ``"block"`` — drain synchronously: the service flushes the pending
      queue first (results are delivered by the *next* ``flush`` call),
      then accepts the request.  Backpressure, no data loss.
    * ``"shed"``  — reject with ``ShedError`` and count it in
      ``totals["shed_requests"]``.  The caller owns the retry.

    ``deadline_s`` is the default per-request deadline (overridable per
    ``submit``): a request still queued when its deadline passes is
    resolved to a ``MappingError("deadline")`` at the next flush instead
    of being mapped, and counted in ``totals["deadline_misses"]``.
    """
    max_pending_reads: int | None = None
    policy: str = "block"
    deadline_s: float | None = None

    POLICIES = ("block", "shed")

    def __post_init__(self):
        if self.policy not in self.POLICIES:
            raise ValueError(f"unknown admission policy {self.policy!r}; "
                             f"expected one of {self.POLICIES}")
        if self.max_pending_reads is not None and self.max_pending_reads < 1:
            raise ValueError(f"max_pending_reads="
                             f"{self.max_pending_reads!r} must be >= 1 "
                             f"(or None for unbounded)")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s={self.deadline_s!r} must be > 0 "
                             f"(or None for no deadline)")


class DegradeLadder:
    """Graceful-degradation state: which config variant is active.

    The ladder is derived from the base config at construction —
    ``fused`` engine steps down to ``compacted`` (same results, one host
    sync more, no single-dispatch fusion).  The backend stays: a block
    that still fails on the last rung is quarantined, never mapped by the
    kernels' plain versions (module docstring).  ``fail()`` after
    ``degrade_after`` consecutive
    block failures advances one rung; ``ok()`` resets the failure streak
    but never climbs back up — a session that had to degrade stays
    degraded (sticky), because the condition that broke the fast path is
    usually still there.
    """

    def __init__(self, cfg: MapperConfig, degrade_after: int = 2):
        rungs = [cfg]
        if cfg.engine == "fused":
            rungs.append(dataclasses.replace(cfg, engine="compacted"))
        self.rungs = rungs
        self.degrade_after = degrade_after
        self.level = 0
        self.steps = 0            # total rungs descended (for stats)
        self._streak = 0

    @property
    def cfg(self) -> MapperConfig:
        return self.rungs[self.level]

    @property
    def degraded(self) -> bool:
        return self.level > 0

    def ok(self) -> None:
        self._streak = 0

    def fail(self) -> bool:
        """Record a block-level failure; True when this one degraded."""
        self._streak += 1
        if (self._streak >= self.degrade_after
                and self.level + 1 < len(self.rungs)):
            self.level += 1
            self.steps += 1
            self._streak = 0
            return True
        return False

    def describe(self) -> str:
        c = self.cfg
        return f"{c.engine}/{c.wf_backend} (rung {self.level}/" \
               f"{len(self.rungs) - 1})"


class FaultInjector:
    """Deterministic fault injection, one site vocabulary for the stack.

    Sites (each an independent, seed-derived RNG stream, so arming one
    site never perturbs another's fault sequence):

    * ``"bucket"``       — transient failure of a mapped block
      (``ResilientMapper``); retries draw fresh Bernoulli trials, so a
      transient fault clears on retry with probability ``1 - rate``.
    * ``"fetch_stall"``  — the streaming engine's fetch thread sleeps
      ``stall_s`` (exercises the ``watchdog_s`` timeout).
    * ``"fetch_error"``  — the fetch thread raises (exercises prompt
      exception propagation out of ``stream_map``).
    * ``"fastq_record"`` — a parsed FASTQ record is treated as corrupt
      (quarantined under ``on_error="permissive"``).
    * ``"flush"``        — ``MappingService.flush`` fails before
      assembly (exercises the transactional resolve-everything path).

    Beyond the Bernoulli sites, ``poison_rows`` marks absolute read rows
    whose block *always* fails — the bisection-quarantine scenario — and
    ``fail_engines`` names engines/backends that always fail, which is
    how the degradation ladder is driven in tests (``{"fused"}`` breaks
    the fused rung and forces the compacted fallback).

    Determinism: RNG streams are keyed on ``(seed, crc32(site))`` —
    stable across processes and Python hash randomization.  ``fired``
    counts the faults each site actually raised.
    """

    def __init__(self, seed: int = 0, rates: dict | None = None, *,
                 stall_s: float = 0.0, poison_rows=(), fail_engines=()):
        self.seed = int(seed)
        self.rates = dict(rates or {})
        self.stall_s = float(stall_s)
        self.poison_rows = frozenset(int(r) for r in poison_rows)
        self.fail_engines = frozenset(fail_engines)
        self.fired: dict[str, int] = {}
        self.checked: dict[str, int] = {}
        self._rngs: dict[str, np.random.Generator] = {}

    @classmethod
    def from_spec(cls, spec: str) -> "FaultInjector":
        """Parse a CLI spec: ``"bucket=0.125,record=0.005,seed=3"``.

        Keys: any site rate (``record`` aliases ``fastq_record``,
        ``stall``/``error`` alias the fetch sites), ``seed``, ``stall_s``
        (the stall duration), ``poison`` (``;``-separated rows) and
        ``engines`` (``;``-separated ``fail_engines``).
        """
        aliases = {"record": "fastq_record", "stall": "fetch_stall",
                   "error": "fetch_error"}
        seed, stall_s, rates, poison, engines = 0, 0.0, {}, (), ()
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in part:
                raise ValueError(f"bad --inject entry {part!r}: "
                                 f"expected key=value")
            k, v = part.split("=", 1)
            if k == "seed":
                seed = int(v)
            elif k == "stall_s":
                stall_s = float(v)
            elif k == "poison":
                poison = [int(r) for r in v.split(";") if r]
            elif k == "engines":
                engines = [e for e in v.split(";") if e]
            else:
                rates[aliases.get(k, k)] = float(v)
        return cls(seed, rates, stall_s=stall_s, poison_rows=poison,
                   fail_engines=engines)

    def _rng(self, site: str) -> np.random.Generator:
        rng = self._rngs.get(site)
        if rng is None:
            rng = np.random.default_rng(
                (self.seed, zlib.crc32(site.encode("ascii"))))
            self._rngs[site] = rng
        return rng

    def fire(self, site: str) -> bool:
        """One Bernoulli trial at ``site``'s rate; advances the stream."""
        self.checked[site] = self.checked.get(site, 0) + 1
        rate = self.rates.get(site, 0.0)
        if rate <= 0.0:
            return False
        hit = bool(self._rng(site).random() < rate)
        if hit:
            self.fired[site] = self.fired.get(site, 0) + 1
        return hit

    def check(self, site: str, detail: str = "") -> None:
        if self.fire(site):
            raise InjectedFault(f"injected {site} fault{detail}")

    def check_block(self, lo: int, hi: int, *, engine: str | None = None,
                    backend: str | None = None) -> None:
        """Bucket-site check for the block covering rows ``[lo, hi)``:
        engine-targeted and poisoned-row faults are persistent (they fire
        on every attempt, at every bisection level, so the failure really
        is quarantined, not retried away); the ``bucket`` rate is the
        transient component."""
        for key in (engine, backend):
            if key is not None and key in self.fail_engines:
                self.fired["engine"] = self.fired.get("engine", 0) + 1
                raise InjectedFault(f"injected engine fault: {key!r} is "
                                    f"marked failing")
        rows = self.poisoned_in(lo, hi)
        if rows:
            self.fired["poison"] = self.fired.get("poison", 0) + 1
            raise InjectedFault(f"injected poisoned read(s) {rows} in "
                                f"rows [{lo}, {hi})")
        self.check("bucket", f" (rows [{lo}, {hi}))")

    def poisoned_in(self, lo: int, hi: int) -> list[int]:
        return sorted(r for r in self.poison_rows if lo <= r < hi)

    def sleep(self, site: str) -> None:
        """Stall the calling thread for ``stall_s`` when ``site`` fires
        (the fetch-thread watchdog scenario)."""
        if self.stall_s > 0 and self.fire(site):
            time.sleep(self.stall_s)

    @property
    def armed(self) -> bool:
        return bool(any(r > 0 for r in self.rates.values())
                    or self.poison_rows or self.fail_engines)


@dataclasses.dataclass(frozen=True)
class BlockFailure:
    """A block that exhausted retries and bisection: its reads are
    quarantined (``MappingResult.failed``), not mapped."""
    message: str
    attempts: int


def _zero_counters() -> dict:
    return dict(retries=0, failed_reads=0, failed_blocks=0,
                degraded_steps=0)


def synthesize_block(n: int, template: MappingResult, cfg: MapperConfig,
                     ) -> dict:
    """Per-field placeholder arrays for ``n`` quarantined reads, shaped
    and typed off a healthy ``template`` result from the same run:
    unmapped (``position=-1``, ``distance=sat``), zero candidates, empty
    traceback.  Raw attribute access keeps a lazy template lazy."""
    sat = cfg.sat_affine

    def raw(f):
        return object.__getattribute__(template, f)

    fill = dict(position=-1, distance=sat, distance2=sat, mapped=False,
                strand=0, ops=OP_NONE, op_count=0,
                linear_dist=cfg.eth + 1, n_candidates=0)
    out = {}
    for f, v in fill.items():
        t = raw(f)
        out[f] = (None if t is None
                  else np.full((n,) + t.shape[1:], v, t.dtype))
    lt = raw("lazy_tb")
    out["lazy_tb"] = None if lt is None else LazyTraceback(
        lt.segments, lt.cfg,
        np.zeros((n,) + lt.reads.shape[1:], lt.reads.dtype),
        np.zeros((n,) + lt.occ.shape[1:], lt.occ.dtype),
        np.zeros((n,) + lt.mpos.shape[1:], lt.mpos.dtype),
        np.zeros(n, bool))
    return out


def merge_stats_list(parts: list, counters: dict | None = None,
                     ) -> MapperStats | None:
    """Sum a run's healthy per-segment ``MapperStats`` into one, folding
    the resilience ``counters`` (retries / quarantined reads / degrade
    steps) into the unified schema.  None when no segment carried stats
    (the padded reference engine)."""
    stats = [s for s in parts if isinstance(s, MapperStats)]
    if not stats:
        return None
    first = stats[0]
    num = {}
    for f in ("reads", "candidates", "survivors", "affine_instances",
              "padded_affine_instances", "dropped_send", "dropped_affine",
              "reverse_best"):
        num[f] = sum(getattr(s, f) for s in stats)
    c = counters or {}
    return MapperStats(
        topology=first.topology, engine=first.engine,
        plan_cache_hits=first.plan_cache_hits,
        plan_cache_misses=first.plan_cache_misses,
        retries=c.get("retries", 0),
        failed_reads=c.get("failed_reads", 0),
        extra={**first.extra, "resilience": dict(c)} if c else
        dict(first.extra), **num)


def assemble_segments(segments: list, cfg: MapperConfig,
                      counters: dict | None = None,
                      ) -> tuple[MappingResult | None, np.ndarray]:
    """Stitch resilient block results back into one ``MappingResult``.

    ``segments`` is the ordered ``[(n_rows, MappingResult|BlockFailure)]``
    cover from ``ResilientMapper.map_segments``.  Failed blocks are
    synthesized as unmapped rows (``synthesize_block``) and flagged in
    the returned quarantine mask / ``MappingResult.failed``; ``stats``
    is the merged healthy accounting.  Returns ``(None, all-True mask)``
    when every block failed — the caller decides the error shape (the
    serving layer resolves each request to a ``MappingError``).
    """
    total = sum(n for n, _ in segments)
    mask = np.zeros(total, dtype=bool)
    healthy = [s for _, s in segments if isinstance(s, MappingResult)]
    off = 0
    for n, s in segments:
        if isinstance(s, BlockFailure):
            mask[off : off + n] = True
        off += n
    if not healthy:
        return None, mask
    if len(segments) == 1 and len(healthy) == 1:
        # fast path (the armed-but-idle case): hand the engine result
        # through untouched apart from folding counters into its stats
        res = segments[0][1]
        object.__setattr__(res, "stats",
                           merge_stats_list([res.stats], counters))
        return res, mask
    template = healthy[0]

    chunks: list[dict] = []
    for n, s in segments:
        if isinstance(s, BlockFailure):
            chunks.append(synthesize_block(n, template, cfg))
        else:
            chunks.append({f: object.__getattribute__(s, f)
                           for f in _PER_READ_FIELDS if f != "failed"}
                          | {"lazy_tb": object.__getattribute__(s,
                                                                "lazy_tb")})

    def cat(f):
        arrs = [c[f] for c in chunks]
        if any(a is None for a in arrs):
            return None
        if f == "lazy_tb":
            return LazyTraceback.concat(arrs)
        return arrs[0] if len(arrs) == 1 else np.concatenate(arrs)

    fields = {f: cat(f) for f in _PER_READ_FIELDS if f != "failed"}
    stats = merge_stats_list([s.stats for s in healthy], counters)
    return MappingResult(**fields, failed=mask if mask.any() else None,
                         stats=stats, lazy_tb=cat("lazy_tb")), mask


class ResilientMapper:
    """Retry / bisect / degrade wrapper around a ``Mapper`` session.

    ``map`` and ``map_pairs`` mirror the ``Mapper`` calls but never
    raise for a contained block failure: quarantined reads come back
    unmapped with ``MappingResult.failed`` set, and the per-call
    ``counters`` (retries, failed reads/blocks, degrade steps) ride in
    ``stats.extra["resilience"]``.  ``map_segments`` is the serving
    layer's lower-level entry — it returns the ordered block cover so
    ``MappingService.flush`` can resolve per-request spans.

    With no injector and no faults the wrapper is one ``try`` per block.
    On the card, the kernel libraries are built and loaded here, and the
    kernels' own errors pass the boundary (module docstring).
    """

    def __init__(self, mapper: Mapper, policy: RetryPolicy = RetryPolicy(),
                 injector: FaultInjector | None = None):
        self.mapper = mapper
        self.policy = policy
        self.injector = injector
        self.ladder = DegradeLadder(mapper.cfg,
                                    degrade_after=policy.degrade_after)
        self.counters = _zero_counters()    # session-cumulative
        self._fallbacks: dict[int, Mapper] = {}
        if mapper.device.type == "cuda":
            if not hasattr(torch, "AcceleratorError"):
                raise RuntimeError(
                    f"ResilientMapper on {mapper.device} needs "
                    f"torch.AcceleratorError (torch >= 2.8; this is "
                    f"{torch.__version__}): without it a CUDA error is a "
                    f"plain RuntimeError, which the containment boundary "
                    f"would retry and bisect instead of raising")
            if mapper.cfg.wf_backend == "cuda":
                _ops.load_mapper_kernels()  # build before containment

    @property
    def cfg(self) -> MapperConfig:
        return self.ladder.cfg

    def _mapper_at(self, level: int) -> Mapper:
        if level == 0:
            return self.mapper
        m = self._fallbacks.get(level)
        if m is None:
            m = self._fallbacks[level] = self.mapper.with_config(
                self.ladder.rungs[level])
        return m

    # ------------------------------------------------------------- mapping

    def map_segments(self, reads: np.ndarray, *, chunk: int | None = None,
                     plan_n: int | None = None, base: int = 0,
                     counters: dict | None = None) -> tuple[list, dict]:
        """Map ``reads`` with containment; -> ``(segments, counters)``.

        ``segments`` is an ordered ``[(n_rows, MappingResult |
        BlockFailure)]`` cover of the input.  ``chunk`` is forwarded to
        the plan (the serving layer's streamed full-bucket runs) and
        ``plan_n`` overrides the planned batch size (the serving layer's
        mesh buckets plan at bucket size, so same-size buckets share one
        plan); halves created by bisection re-plan at their own size.  ``base`` is the
        absolute row offset of ``reads[0]`` — the coordinate the
        injector's ``poison_rows`` are expressed in.  The kernels' own
        errors are re-raised at once (module docstring).
        """
        counters = counters if counters is not None else _zero_counters()
        n = len(reads)
        if n == 0:
            return [], counters
        pol = self.policy
        last_exc: BaseException | None = None
        attempts = 0
        while attempts < pol.max_attempts:
            m = self._mapper_at(self.ladder.level)
            try:
                if self.injector is not None:
                    self.injector.check_block(base, base + n,
                                              engine=m.cfg.engine,
                                              backend=m.cfg.wf_backend)
                res = m.run(m.plan(plan_n if plan_n is not None else n,
                                   chunk=chunk), reads)
                if len(res.position) != n:
                    raise RuntimeError(
                        f"engine returned {len(res.position)} rows for "
                        f"{n} reads")
                self.ladder.ok()
                return [(n, res)], counters
            except _KERNEL_ERRORS:
                raise
            except Exception as e:  # noqa: BLE001 — containment boundary
                last_exc = e
                attempts += 1
                if attempts < pol.max_attempts:
                    counters["retries"] += 1
                    self.counters["retries"] += 1
                    _obs_inc("repro_retries_total")
                    if pol.backoff_s > 0:
                        time.sleep(pol.backoff_s
                                   * pol.backoff_mult ** (attempts - 1))
        if self.ladder.fail():
            counters["degraded_steps"] += 1
            self.counters["degraded_steps"] += 1
            _obs_inc("repro_degradations_total")
            print(f"resilience: {type(last_exc).__name__}: {last_exc}; "
                  f"engine ladder down to {self.ladder.describe()}",
                  file=sys.stderr)
        if n > max(pol.bisect_min, 1):
            # quarantine by bisection: each half retries independently,
            # so the poisoned half shrinks while the healthy half maps
            _obs_inc("repro_bisections_total")
            mid = n // 2
            left, _ = self.map_segments(reads[:mid], base=base,
                                        counters=counters)
            right, _ = self.map_segments(reads[mid:], base=base + mid,
                                         counters=counters)
            return left + right, counters
        counters["failed_reads"] += n
        counters["failed_blocks"] += 1
        self.counters["failed_reads"] += n
        self.counters["failed_blocks"] += 1
        _obs_inc("repro_quarantined_reads_total", n)
        _obs_inc("repro_failed_blocks_total")
        msg = f"{type(last_exc).__name__}: {last_exc}"
        return [(n, BlockFailure(message=msg, attempts=attempts))], counters

    def map(self, reads: np.ndarray) -> tuple[MappingResult | None,
                                              np.ndarray, dict]:
        """Plan + run with containment -> ``(result, failed_mask,
        counters)``.  ``result`` is None only when *every* block failed
        (the mask is then all-True)."""
        reads = np.asarray(reads)
        segments, counters = self.map_segments(reads)
        res, mask = assemble_segments(segments, self.cfg, counters)
        return res, mask, counters

    def map_pairs(self, reads1: np.ndarray, reads2: np.ndarray):
        """Paired twin of ``Mapper.map_pairs``: one stacked resilient
        batch, split back per mate -> ``(res1, res2, counters)`` (None
        results when everything failed; the ``failed`` masks split with
        the other per-read fields)."""
        from .mapper import split_result
        reads1, reads2 = np.asarray(reads1), np.asarray(reads2)
        if reads1.shape != reads2.shape:
            raise ValueError(f"mate batches must align pairwise: "
                             f"{reads1.shape} vs {reads2.shape}")
        res, mask, counters = self.map(np.concatenate([reads1, reads2]))
        if res is None:
            return None, None, counters
        r1, r2 = split_result(res, len(reads1))
        return r1, r2, counters
