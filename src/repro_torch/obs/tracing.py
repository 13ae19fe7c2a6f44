"""Span tracing with Chrome trace-event export (Perfetto-loadable) — a copy
of ``repro.obs.tracing``'s ``Tracer``, with the port's one span hook,
``span``, which records into it and into a ``torch.profiler`` trace.

Second pillar of ``repro_torch.obs``: every chunk's lifecycle (ingest ->
host prep -> H2D -> seed -> linear -> affine -> traceback -> D2H -> SAM
emit) is recorded as **complete spans** carrying chunk attribution, and
exported as Chrome trace-event JSON (the ``{"traceEvents": [...]}``
container) that loads directly in Perfetto / ``chrome://tracing``.

``span(name)`` is the hook the mapper's hot path uses at each boundary.
It records when someone is looking:

  * a launcher has armed the tracer (``enable_tracing``, ``--trace-out``):
    the span goes into ``tracer()``;
  * a ``torch.profiler`` records in this process: the span goes into the
    profile's own record (``profiled()``, readable after the profiler
    stops; each new profile starts a fresh one) and opens
    ``torch.profiler.record_function`` of the same name, so it lies on
    the device trace's clock.

Otherwise it returns a shared null context: one global load, one
attribute load and a branch.  A recorded span carries its name, thread,
start and end (two ``perf_counter`` reads), its own id and its parent's
(the innermost span open on the same thread), and the thread's context
(``set_ctx``: ``call``, the id of the ``mapper.run`` span it belongs to,
and ``chunk``).  Arguments known only inside the span (byte counts) are
given with ``Span.set``, so an unrecorded span never computes them.

A stage span (``span(name, times)``: the stages of ``stage_times_s``)
also runs its clock when handed a ``times`` dict, and adds its seconds
there from the same two reads, so ``stage_times_s`` and the trace's
totals of the same names are equal by construction — the acceptance
property ``tests/test_torch_obs.py`` locks.  Where the metrics registry
is armed, a recorded or timed span feeds the counters from the same
numbers: ``repro_stage_seconds_total{stage}`` (stage spans),
``repro_device_syncs_total{site}`` (``sync`` spans) and
``repro_<name>_bytes_total{memory}`` (copy spans: those with a
``pageable`` argument beside their ``bytes``).

Memory is bounded by ``max_events`` — a long run drops and counts excess
events rather than growing without limit.  This module is a leaf of the
package: it imports the registry and torch's profiler, nothing of
``repro_torch.core``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _P

from . import registry as _metrics

__all__ = ["Tracer", "SpanRecord", "enable_tracing", "disable_tracing",
           "tracer", "recording", "profiled", "span", "set_ctx", "get_ctx",
           "clear_ctx"]

_tls = threading.local()


def set_ctx(**kw) -> None:
    """Replace this thread's span-attribution context (e.g. chunk=3)."""
    _tls.ctx = kw


def get_ctx() -> dict | None:
    return getattr(_tls, "ctx", None)


def clear_ctx() -> None:
    _tls.ctx = None


class SpanRecord(NamedTuple):
    """One recorded span: ``sid`` and ``parent`` are None for spans added
    with ``Tracer.add`` alone."""
    name: str
    thread: int
    t0: float
    t1: float
    args: dict | None
    sid: int | None
    parent: int | None


class Tracer:
    """Bounded in-memory span collector with Chrome trace-event export."""

    def __init__(self, max_events: int = 1_000_000):
        self.max_events = max_events
        self.epoch = time.perf_counter()
        self.dropped = 0
        self._events: list[SpanRecord] = []
        self._lock = threading.Lock()

    def add(self, name: str, t0: float, t1: float,
            args: dict | None = None, *, sid: int | None = None,
            parent: int | None = None) -> None:
        """Record a complete span from two ``perf_counter`` reads; the
        calling thread's context (``set_ctx``) merges into ``args``."""
        ctx = getattr(_tls, "ctx", None)
        if ctx:
            args = {**ctx, **args} if args else dict(ctx)
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(SpanRecord(
                name, threading.get_ident(), t0, t1, args, sid, parent))

    @contextlib.contextmanager
    def span(self, name: str, **args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter(), args or None)

    def __len__(self) -> int:
        return len(self._events)

    def spans(self) -> list[SpanRecord]:
        """The recorded spans, in the order they closed."""
        with self._lock:
            return list(self._events)

    def stage_totals(self) -> dict:
        """Summed span seconds by name — ``stage_times_s``, re-derived
        from the trace (bit-equal where both exist: same clock reads)."""
        out: dict[str, float] = {}
        for e in self.spans():
            out[e.name] = out.get(e.name, 0.0) + (e.t1 - e.t0)
        return out

    def chrome(self) -> dict:
        """The trace as a Chrome trace-event JSON object; a hook span's
        id and parent ride in its ``args``."""
        events = self.spans()
        pid = os.getpid()
        tids: dict[int, int] = {}
        out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": "repro"}}]
        for name, ident, t0, t1, args, sid, parent in events:
            tid = tids.setdefault(ident, len(tids))
            ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
                  "ts": (t0 - self.epoch) * 1e6,
                  "dur": (t1 - t0) * 1e6}
            if sid is not None:
                args = {**(args or {}), "id": sid, "parent": parent}
            if args:
                ev["args"] = args
            out.append(ev)
        for ident, tid in tids.items():
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": f"thread-{tid}"}})
        meta = {"dropped_events": self.dropped} if self.dropped else {}
        return {"traceEvents": out, "displayTimeUnit": "ms", **meta}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome(), f)
            f.write("\n")


# --------------------------------------------------------------- global
ACTIVE: Tracer | None = None
# the record of the latest torch.profiler profile (``profiled``)
PROFILED: Tracer | None = None


def enable_tracing(max_events: int = 1_000_000,
                   tracer_: Tracer | None = None) -> Tracer:
    """Arm the process-wide tracer (idempotent; pass ``tracer_`` to
    install a specific instance)."""
    global ACTIVE
    if tracer_ is not None:
        ACTIVE = tracer_
    elif ACTIVE is None:
        ACTIVE = Tracer(max_events=max_events)
    return ACTIVE


def disable_tracing() -> Tracer | None:
    """Disarm; returns the tracer that was active (for a final export)."""
    global ACTIVE
    t, ACTIVE = ACTIVE, None
    return t


def tracer() -> Tracer | None:
    return ACTIVE


def recording() -> bool:
    """Whether spans record now: a tracer is armed or a ``torch.profiler``
    records in this process."""
    return ACTIVE is not None or _P._is_profiler_enabled


def profiled() -> Tracer | None:
    """The spans recorded under the latest ``torch.profiler`` profile of
    this process (during it, and after it stopped); None before any."""
    return PROFILED


def _on_profiler_start(_start=_P._run_on_profiler_start) -> None:
    """Each profile starts a fresh ``PROFILED`` record: torch runs this
    where a profiler starts recording (``_run_on_profiler_start``)."""
    global PROFILED
    _start()
    PROFILED = Tracer()


if not hasattr(_P._run_on_profiler_start, "_repro_torch"):
    _on_profiler_start._repro_torch = True
    _P._run_on_profiler_start = _on_profiler_start


# ------------------------------------------------------------- the hook
_ids = itertools.count(1)
# not a stage: ``span``'s default ``times``
_NO_STAGE = object()


class _Off:
    """The span of nobody looking: a shared null context."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """A span that records (see ``span``); ``set`` adds arguments."""
    __slots__ = ("name", "times", "args", "sid", "parent", "t0", "rf",
                 "prev_ctx")

    def __init__(self, name: str, times, args: dict):
        self.name, self.times, self.args = name, times, args
        self.rf = self.prev_ctx = None

    def set(self, **kw) -> None:
        self.args.update(kw)

    def scope(self, **kw) -> None:
        """Add ``kw`` to this thread's context (``set_ctx``) until this
        span closes, and to the span's own arguments."""
        self.prev_ctx = get_ctx() or {}
        set_ctx(**{**self.prev_ctx, **kw})
        self.args.update(kw)

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self.parent = stack[-1] if stack else None
        self.sid = next(_ids)
        stack.append(self.sid)
        if _P._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _tls.stack.pop()
        if self.prev_ctx is not None:
            set_ctx(**self.prev_ctx)
        name, t0, args = self.name, self.t0, self.args
        stage = self.times is not _NO_STAGE
        if stage and self.times is not None:
            self.times[name] = self.times.get(name, 0.0) + (t1 - t0)
        for tr in (ACTIVE, PROFILED if self.rf is not None else None):
            if tr is not None:
                tr.add(name, t0, t1, dict(args) if args else None,
                       sid=self.sid, parent=self.parent)
        reg = _metrics.ACTIVE
        if reg is not None:
            if stage:
                reg.counter("repro_stage_seconds_total",
                            stage=name).inc(t1 - t0)
            if name == "sync":
                reg.counter("repro_device_syncs_total",
                            site=args["site"]).inc()
            if "pageable" in args:
                reg.counter(f"repro_{name}_bytes_total",
                            memory=("pageable" if args.get("pageable")
                                    else "pinned")).inc(args["bytes"])
        return False


def span(name: str, times=_NO_STAGE, **args):
    """The port's span hook: a context manager that yields a ``Span``
    where the span records, else None (``with span(...) as sp: if sp:
    sp.set(bytes=...)``).

    It records where a tracer is armed or a ``torch.profiler`` records
    (see the module docstring).  ``times`` makes it a stage span of
    ``stage_times_s``: pass the dict to fill, or None; a dict also runs
    the span's clock when nothing records.  ``args`` are its arguments
    (``site=`` for a ``sync``)."""
    if (ACTIVE is None and not _P._is_profiler_enabled
            and (times is None or times is _NO_STAGE)):
        return _OFF
    return Span(name, times, args)
