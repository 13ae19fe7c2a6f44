"""Chunk streaming (throughput mode, paper Sec. V-C) — torch twin of
``repro.core.streaming``.

``stream_map`` keeps three chunks in flight:

  chunk i+1   host pad/encode + H2D transfer + seeding        (phase 1)
  chunk i     capacity-count syncs + WF stage launches        (phase 2)
  chunk i-1   device->host result fetch, on a fetch thread    (phase 3)

PyTorch queues CUDA work without waiting, so chunk i+1's transfer and
seeding are in the device queue while chunk i's count syncs wait.
Everything runs on the current stream; copies to and from pageable host
memory are not overlapped with kernels yet.

``sync_map`` is the fully synchronous path (``stream=False``): it waits
at every stage boundary and records per-stage wall times.  Both run the
same phases with the same capacities, so their outputs are identical.

The reference donates each chunk's device buffers into its stages (JAX
buffer donation, ``donatable_argnums``); torch frees a tensor when its
last reference goes, so here the schedule drops its references instead:
a chunk's phase-1 state once phase 2 has taken it, and its phase-2
outputs once the fetch has copied them to the host.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError

from ..obs import registry as _metrics
from ..obs import tracing as _tracing

__all__ = ["stream_map", "sync_map", "timed", "FetchStallError"]


class FetchStallError(RuntimeError):
    """The fetch thread exceeded the streaming watchdog (``watchdog_s``).

    A device-to-host copy that never completes surfaces as this error
    instead of hanging ``stream_map``; the resilience layer treats it like
    any other block failure (retry, then quarantine).  Defined here so the
    streaming layer has no upward imports; ``resilience`` re-exports it.
    """


def timed(times: dict | None, key: str, t0: float) -> float:
    """Accumulate ``now - t0`` into ``times[key]``; returns a fresh t0.

    No-op (beyond the clock read) when ``times`` is None.  This is also
    the observability layer's stage hook: when the ``repro_torch.obs``
    tracer or registry is armed, the *same two clock reads* emit a span
    (with the calling thread's chunk context) and accrue the per-stage
    seconds counter, so the trace, the metrics and ``stage_times_s`` agree
    on every duration.
    """
    t1 = time.perf_counter()
    if times is not None:
        times[key] = times.get(key, 0.0) + (t1 - t0)
        tr = _tracing.ACTIVE
        if tr is not None:
            tr.add(key, t0, t1)
        reg = _metrics.ACTIVE
        if reg is not None:
            reg.counter("repro_stage_seconds_total", stage=key).inc(t1 - t0)
    return t1


def stream_map(items: list, phase1, phase2, fetch,
               times: dict | None = None, *, injector=None,
               watchdog_s: float | None = None) -> list:
    """Overlapped execution over ``items`` (one per chunk).

    phase1(item)   -> state   : host prep + H2D + seeding
    phase2(state)  -> outs    : count syncs + remaining stages
    fetch(outs)    -> result  : blocking device->host copy (fetch thread)

    phase1 of chunk i+1 is issued before phase2 of chunk i waits on its
    counts; fetches run on a worker thread.  Results come back in
    submission order.  ``times`` (``MapperConfig.profile``) goes to the
    fetch calls only, which run on the one fetch worker.  A failed fetch
    is raised before more chunks are dispatched.

    ``watchdog_s`` bounds each fetch's wall time: a fetch past it raises
    ``FetchStallError``, and the pool is abandoned, not joined, so the
    stalled thread cannot hang the caller a second time.  ``injector`` is
    the chaos hook: each fetch first runs ``injector.sleep("fetch_stall")``
    and ``injector.check("fetch_error")`` on the fetch thread.
    """
    n = len(items)
    if n == 0:
        return []

    if injector is None:
        run_fetch = fetch
    else:
        def run_fetch(outs, times_):
            injector.sleep("fetch_stall")
            injector.check("fetch_error")
            return fetch(outs, times_)

    # chunk attribution for span tracing: each phase stamps the in-flight
    # chunk index on whichever thread runs it
    tracing_on = _tracing.ACTIVE is not None

    def fetch_job(i, outs):
        if tracing_on:
            _tracing.set_ctx(chunk=i)
        return run_fetch(outs, times)

    reg = _metrics.ACTIVE
    if reg is not None:
        reg.counter("repro_chunks_total", mode="stream").inc(n)

    futs = []
    pool = ThreadPoolExecutor(max_workers=1,
                              thread_name_prefix="stream-fetch")
    try:
        if tracing_on:
            _tracing.set_ctx(chunk=0)
        state = phase1(items[0])
        for i in range(n):
            for f in futs:
                if f.done():
                    f.result()
            if tracing_on:
                _tracing.set_ctx(chunk=i + 1)
            nxt = phase1(items[i + 1]) if i + 1 < n else None
            if tracing_on:
                _tracing.set_ctx(chunk=i)
            outs = phase2(state)
            state = nxt
            futs.append(pool.submit(fetch_job, i, outs))
            del outs
        out = []
        for i, f in enumerate(futs):
            try:
                out.append(f.result(timeout=watchdog_s))
            except FutureTimeoutError:
                # abandon the wedged worker instead of joining it
                pool.shutdown(wait=False, cancel_futures=True)
                pool = None
                raise FetchStallError(
                    f"fetch of chunk {i}/{n} exceeded the streaming "
                    f"watchdog ({watchdog_s}s); device queue or fetch "
                    f"thread is stalled") from None
        return out
    finally:
        if pool is not None:
            pool.shutdown(wait=True)


def sync_map(items: list, phase1, phase2, fetch,
             times: dict | None = None) -> list:
    """Fully synchronous chunk execution (the ``stream=False`` path)."""
    reg = _metrics.ACTIVE
    if reg is not None:
        reg.counter("repro_chunks_total", mode="sync").inc(len(items))
    tracing_on = _tracing.ACTIVE is not None
    out = []
    for i, item in enumerate(items):
        if tracing_on:
            _tracing.set_ctx(chunk=i)
        out.append(fetch(phase2(phase1(item, times=times), times=times),
                         times=times))
    return out
