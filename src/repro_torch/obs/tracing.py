"""Span tracing with Chrome trace-event export (Perfetto-loadable) — a copy
of ``repro.obs.tracing`` apart from ``annotate``, which names a span in a
``torch.profiler`` trace.

Second pillar of ``repro_torch.obs``: every chunk's lifecycle (ingest -> H2D
-> seed -> linear -> affine -> traceback -> D2H -> SAM emit) is recorded
as **complete spans** carrying chunk/shard attribution, and exported as
Chrome trace-event JSON (the ``{"traceEvents": [...]}`` container) that
loads directly in Perfetto / ``chrome://tracing``.

The central integration point is ``repro_torch.core.streaming.timed``: every
per-stage wall-time accumulation *also* emits a span from the **same
two clock reads**, so the exported trace's per-stage durations and the
legacy ``stage_times_s`` dict are identical by construction — the
acceptance property ``tests/test_torch_obs.py`` locks.

Attribution rides a thread-local context (``set_ctx(chunk=i)``): the
streaming engine stamps the in-flight chunk index on whichever thread
(dispatch or fetch) runs each phase, so overlapping chunks untangle in
the viewer.  Memory is bounded by ``max_events`` — a long run drops and
counts excess events rather than growing without limit.

Like the registry, this module is a leaf with a module-global ``ACTIVE``
tracer: disabled cost is one attribute load + ``is None`` branch.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

__all__ = ["Tracer", "enable_tracing", "disable_tracing", "tracer",
           "set_ctx", "get_ctx", "clear_ctx", "annotate"]

_tls = threading.local()


def set_ctx(**kw) -> None:
    """Replace this thread's span-attribution context (e.g. chunk=3)."""
    _tls.ctx = kw


def get_ctx() -> dict | None:
    return getattr(_tls, "ctx", None)


def clear_ctx() -> None:
    _tls.ctx = None


class Tracer:
    """Bounded in-memory span collector with Chrome trace-event export."""

    def __init__(self, max_events: int = 1_000_000):
        self.max_events = max_events
        self.epoch = time.perf_counter()
        self.dropped = 0
        self._events: list[tuple] = []   # (name, tid, t0, t1, args)
        self._lock = threading.Lock()

    def add(self, name: str, t0: float, t1: float,
            args: dict | None = None) -> None:
        """Record a complete span from two ``perf_counter`` reads; the
        calling thread's context (``set_ctx``) merges into ``args``."""
        ctx = getattr(_tls, "ctx", None)
        if ctx:
            args = {**ctx, **args} if args else dict(ctx)
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(
                (name, threading.get_ident(), t0, t1, args))

    @contextlib.contextmanager
    def span(self, name: str, **args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter(), args or None)

    def __len__(self) -> int:
        return len(self._events)

    def stage_totals(self) -> dict:
        """Summed span seconds by name — ``stage_times_s``, re-derived
        from the trace (bit-equal where both exist: same clock reads)."""
        out: dict[str, float] = {}
        with self._lock:
            events = list(self._events)
        for name, _tid, t0, t1, _args in events:
            out[name] = out.get(name, 0.0) + (t1 - t0)
        return out

    def chrome(self) -> dict:
        """The trace as a Chrome trace-event JSON object."""
        with self._lock:
            events = list(self._events)
        pid = os.getpid()
        tids: dict[int, int] = {}
        out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": "repro"}}]
        for name, ident, t0, t1, args in events:
            tid = tids.setdefault(ident, len(tids))
            ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
                  "ts": (t0 - self.epoch) * 1e6,
                  "dur": (t1 - t0) * 1e6}
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


def annotate(name: str):
    """``torch.profiler.record_function(name)`` when tracing is armed,
    else a null context — the hook that names engine dispatches inside a
    ``torch.profiler`` trace without taxing un-traced runs."""
    if ACTIVE is None:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)
