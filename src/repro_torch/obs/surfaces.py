"""The launchers' observability surfaces: ``--log-json``,
``--metrics-out`` and ``--trace-out`` armed around a run
(``obs_surfaces``), and the metrics JSONL writer (``metrics_snapshot``).
Shared by ``map_fastq``, ``build_index`` and ``serve``."""
from __future__ import annotations

import contextlib
import json
import time

from . import logjson
from . import registry as _metrics
from . import tracing as _tracing


def metrics_snapshot(path, seq: int) -> None:
    """Append one registry snapshot line to the ``--metrics-out`` JSONL
    (schema: ``schemas/metrics_snapshot.schema.json``)."""
    reg = _metrics.ACTIVE
    if path is None or reg is None:
        return
    rec = dict(kind="metrics_snapshot", seq=seq, ts_unix_s=time.time())
    rec.update(reg.snapshot())
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def obs_surfaces(component: str, *, trace_out=None, metrics_out=None,
                 log_json=False, arm_metrics=None, final_snapshot=False):
    """Arm the ``--log-json`` / ``--metrics-out`` / ``--trace-out``
    surfaces a launcher asked for and always tear them down; the trace is
    exported even when the run fails.  The registry is armed for
    ``metrics_out`` (or when ``arm_metrics`` says so).  Yields whether
    this call armed a fresh registry (closing stats are re-derived from
    the registry only then: an inherited one holds earlier runs).
    ``metrics_out`` is truncated on entry; with ``final_snapshot`` one
    snapshot is written on exit (launchers without per-chunk
    snapshots)."""
    if arm_metrics is None:
        arm_metrics = metrics_out is not None
    log_on = log_json and not logjson.enabled()
    metrics_on = arm_metrics and _metrics.ACTIVE is None
    tracing_on = trace_out is not None and _tracing.ACTIVE is None
    if log_on:
        logjson.enable(component)
    if metrics_on:
        _metrics.enable_metrics()
    if tracing_on:
        _tracing.enable_tracing()
    if metrics_out is not None:
        open(metrics_out, "w").close()   # truncate; snapshots append
    try:
        yield metrics_on
    finally:
        if final_snapshot:
            metrics_snapshot(metrics_out, seq=0)
        if trace_out is not None and _tracing.ACTIVE is not None:
            _tracing.ACTIVE.export(trace_out)
        if tracing_on:
            _tracing.disable_tracing()
        if metrics_on:
            _metrics.disable_metrics()
        if log_on:
            logjson.disable()
