"""The program's own spans in a traced window.

Under ``torch.profiler`` the program records each span of its chunk
schedule (``repro_torch.obs.tracing.span``) into a record of the profile,
which ``repro_torch.obs.profiled()`` returns after the profiler stops: a
span's name, thread, start and end, id, parent and arguments.  The
readers here reduce the window's record for the per-layer metrics; each
returns None where the record holds no span of the kind it reads, as a
program without that record gives.
"""
from __future__ import annotations


def record() -> list | None:
    """The spans the program recorded under the window's profiler, or
    None where it has no such record or recorded nothing."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    profiled = getattr(obs, "profiled", None)
    rec = profiled() if profiled is not None else None
    spans = rec.spans() if rec is not None else []
    return spans or None


def _union_s(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def schedule(spans: list | None) -> dict | None:
    """The caller's time in the window's ``mapper.run`` spans, split:
    ``run_s`` all of it, ``wait_s`` the part covered by its ``sync`` and
    ``fetch_wait`` descendants (the host blocked on the device or on the
    fetch thread); ``runs`` and ``syncs`` count the spans.  None without
    a ``mapper.run`` span."""
    if not spans:
        return None
    runs = {s.sid: s for s in spans if s.name == "mapper.run"}
    if not runs:
        return None
    parent = {s.sid: s.parent for s in spans if s.sid is not None}
    waits: dict[int, list] = {sid: [] for sid in runs}
    syncs = 0
    for s in spans:
        if s.name not in ("sync", "fetch_wait"):
            continue
        p = s.parent
        while p is not None and p not in runs:
            p = parent.get(p)
        if p is None:
            continue
        waits[p].append((s.t0, s.t1))
        syncs += s.name == "sync"
    return dict(run_s=sum(r.t1 - r.t0 for r in runs.values()),
                wait_s=sum(_union_s(w) for w in waits.values()),
                runs=len(runs), syncs=syncs)


def copies(spans: list | None, name: str = "d2h") -> dict | None:
    """Bytes of the window's ``name`` copy spans, and how many of them
    moved to or from pageable host memory.  None without such a span."""
    got = [s.args for s in spans or () if s.name == name
           and s.args and "bytes" in s.args]
    if not got:
        return None
    return dict(bytes=sum(a["bytes"] for a in got),
                pageable=sum(a["bytes"] for a in got if a.get("pageable")))


def seconds(spans: list | None, name: str) -> float | None:
    """Summed seconds of the window's spans named ``name``; None without
    one."""
    got = [s.t1 - s.t0 for s in spans or () if s.name == name]
    return sum(got) if got else None
