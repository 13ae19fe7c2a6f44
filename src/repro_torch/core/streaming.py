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
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

__all__ = ["stream_map", "sync_map", "timed"]


def timed(times: dict | None, key: str, t0: float) -> float:
    """Accumulate ``now - t0`` into ``times[key]`` (when ``times`` is not
    None); returns a fresh t0."""
    t1 = time.perf_counter()
    if times is not None:
        times[key] = times.get(key, 0.0) + (t1 - t0)
    return t1


def stream_map(items: list, phase1, phase2, fetch,
               times: dict | None = None) -> list:
    """Overlapped execution over ``items`` (one per chunk).

    phase1(item)   -> state   : host prep + H2D + seeding
    phase2(state)  -> outs    : count syncs + remaining stages
    fetch(outs)    -> result  : blocking device->host copy (fetch thread)

    phase1 of chunk i+1 is issued before phase2 of chunk i waits on its
    counts; fetches run on a worker thread.  Results come back in
    submission order.  ``times`` (``MapperConfig.profile``) goes to the
    fetch calls only, which run on the one fetch worker.  A failed fetch
    is raised before more chunks are dispatched.
    """
    n = len(items)
    if n == 0:
        return []
    futs = []
    with ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="stream-fetch") as pool:
        state = phase1(items[0])
        for i in range(n):
            for f in futs:
                if f.done():
                    f.result()
            nxt = phase1(items[i + 1]) if i + 1 < n else None
            outs = phase2(state)
            futs.append(pool.submit(fetch, outs, times))
            state = nxt
        return [f.result() for f in futs]


def sync_map(items: list, phase1, phase2, fetch,
             times: dict | None = None) -> list:
    """Fully synchronous chunk execution (the ``stream=False`` path)."""
    return [fetch(phase2(phase1(item, times=times), times=times),
                  times=times)
            for item in items]
