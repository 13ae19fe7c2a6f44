"""``repro_torch.obs`` — unified observability: metrics, tracing, surfaces
(the twin of ``repro.obs``: the same metric names, trace and snapshot
format).

Three pillars over one design rule (near-zero cost when disabled,
bounded memory when enabled):

* ``registry`` — the process-wide metrics registry
  (counters / gauges / fixed-log-bucket histograms), wired through the
  streaming engine, ``Mapper``, ``DeviceResidency``, ``ResilientMapper``
  and ``MappingService``;
* ``tracing``  — chunk-lifecycle span tracing exported as
  Chrome trace-event JSON (Perfetto-loadable), sharing clock reads with
  ``stage_times_s`` so the two surfaces agree by construction;
* ``logjson`` / ``server`` — structured JSON logging and Prometheus
  text exposition for the launchers (``--trace-out`` /
  ``--metrics-out`` / ``--log-json`` / ``--metrics-port``), armed around
  a launcher's run by ``surfaces.obs_surfaces``.

The package is a **leaf**: nothing here imports ``repro_torch.core``
or ``repro_torch.index``, so every layer may instrument itself without
cycles.
"""
from . import logjson, server, validate
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       disable_metrics, enable_metrics, metrics)
from .surfaces import metrics_snapshot, obs_surfaces
from .tracing import (Tracer, annotate, clear_ctx, disable_tracing,
                      enable_tracing, get_ctx, set_ctx, tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "enable_metrics", "disable_metrics", "metrics",
    "Tracer", "enable_tracing", "disable_tracing", "tracer",
    "set_ctx", "get_ctx", "clear_ctx", "annotate",
    "logjson", "server", "validate", "metrics_snapshot", "obs_surfaces",
]
