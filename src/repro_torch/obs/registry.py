"""Process-wide metrics registry: counters, gauges, bounded histograms (a
copy of ``repro.obs.registry``: the same names, edges and snapshot).

The observability layer's first pillar (the other two live in
``repro_torch.obs.tracing`` and the launcher surfaces).  Design constraints,
in order:

* **near-zero cost when disabled** — hot paths guard on the module
  global ``ACTIVE`` (one attribute load + ``is None`` branch) and touch
  nothing else;
* **bounded memory always** — histograms use *fixed log-spaced bucket
  edges* (no per-observation storage), and per-name label sets are
  capped at ``MAX_LABEL_SETS`` with an explicit overflow series, so a
  long-lived serving process cannot grow the registry without bound no
  matter what label values (tenant ids, bucket sizes) flow through it;
* **one source of truth** — the launchers re-derive their closing-stats
  lines from these instruments (``mapper.totals_from_registry``), and
  the Prometheus text endpoint / JSONL snapshots read the same objects,
  so the numbers cannot disagree between surfaces.

This module is a **leaf**: it imports nothing from ``repro_torch.core``
/ ``repro_torch.index`` so every layer of the stack may instrument itself
without import cycles.
"""
from __future__ import annotations

import bisect
import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "enable_metrics", "disable_metrics", "metrics",
           "DEFAULT_BUCKET_EDGES", "MAX_LABEL_SETS"]


def _log_edges(lo: float = 1e-6, hi: float = 1e3,
               per_decade: int = 5) -> tuple:
    """Fixed log-spaced bucket upper edges covering ``[lo, hi]``.

    5 edges/decade over 9 decades = 46 buckets (+1 overflow): enough
    resolution for ~15% relative-error quantiles on latencies from a
    microsecond to a quarter hour, in a few hundred bytes per histogram.
    """
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


DEFAULT_BUCKET_EDGES = _log_edges()

# distinct label-sets allowed per metric name before new label values
# collapse into one overflow series — the bound that keeps per-tenant /
# per-shard labels safe in a long-lived service
MAX_LABEL_SETS = 64
_OVERFLOW_LABELS = (("other", "true"),)


class Counter:
    """Monotonic counter (int or float increments)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (queue depth, resident rows)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n

    def dec(self, n=1) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket log-spaced histogram; memory is O(len(edges)), never
    O(observations).  ``quantile`` returns the upper edge of the bucket
    holding the requested rank (observations above the last edge report
    the last edge — the histogram's bounded-range contract)."""

    __slots__ = ("name", "labels", "edges", "counts", "count", "sum",
                 "_lock")

    def __init__(self, name: str, labels: tuple = (),
                 edges: tuple = DEFAULT_BUCKET_EDGES):
        self.name = name
        self.labels = labels
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)   # +1: overflow bucket
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                return self.edges[min(i, len(self.edges) - 1)]
        return self.edges[-1]

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self.counts)
            n, s = self.count, self.sum
        buckets = {}
        for i, c in enumerate(counts):
            if c:
                le = ("+Inf" if i >= len(self.edges)
                      else f"{self.edges[i]:.6g}")
                buckets[le] = c
        return dict(count=n, sum=s, p50=self.quantile(0.5),
                    p95=self.quantile(0.95), p99=self.quantile(0.99),
                    buckets=buckets)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Name + labels -> instrument, with per-name label-set bounding.

    ``counter("repro_reads_total", topology="single")`` returns the same
    object on every call, creating it on first use.  A metric name is
    permanently bound to one instrument kind (mixing kinds raises).
    """

    def __init__(self, max_label_sets: int = MAX_LABEL_SETS):
        self.max_label_sets = max_label_sets
        self._lock = threading.Lock()
        self._families: dict[str, dict[tuple, object]] = {}
        self._kinds: dict[str, str] = {}

    def _get(self, kind: str, name: str, labels: dict):
        key = tuple(sorted(labels.items())) if labels else ()
        fam = self._families.get(name)
        if fam is not None and self._kinds.get(name) == kind:
            inst = fam.get(key)
            if inst is not None:
                return inst
        with self._lock:
            known = self._kinds.setdefault(name, kind)
            if known != kind:
                raise ValueError(f"metric {name!r} is a {known}, not a "
                                 f"{kind}")
            fam = self._families.setdefault(name, {})
            inst = fam.get(key)
            if inst is None:
                if key and len(fam) >= self.max_label_sets:
                    key = _OVERFLOW_LABELS   # bounded cardinality
                    inst = fam.get(key)
                    if inst is not None:
                        return inst
                inst = fam[key] = _KINDS[kind](name, key)
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    # ------------------------------------------------------------ export
    @staticmethod
    def _series(name: str, labels: tuple) -> str:
        if not labels:
            return name
        inner = ",".join(f'{k}="{v}"' for k, v in labels)
        return f"{name}{{{inner}}}"

    def snapshot(self) -> dict:
        """JSON-serializable state: one flat dict per instrument kind,
        keyed by the Prometheus-style series name."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            items = [(name, self._kinds[name], dict(fam))
                     for name, fam in self._families.items()]
        for name, kind, fam in items:
            for labels, inst in sorted(fam.items()):
                series = self._series(name, labels)
                if kind == "histogram":
                    out["histograms"][series] = inst.snapshot()
                else:
                    v = inst.value
                    out["counters" if kind == "counter"
                        else "gauges"][series] = (
                        int(v) if isinstance(v, int) else float(v))
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4)."""
        lines = []
        with self._lock:
            items = sorted((name, self._kinds[name], dict(fam))
                           for name, fam in self._families.items())
        for name, kind, fam in items:
            lines.append(f"# TYPE {name} {kind}")
            for labels, inst in sorted(fam.items()):
                if kind != "histogram":
                    lines.append(f"{self._series(name, labels)} "
                                 f"{inst.value}")
                    continue
                snap = inst.snapshot()
                cum = 0
                for i, edge in enumerate(inst.edges):
                    cum += inst.counts[i]
                    if inst.counts[i]:
                        ll = labels + (("le", f"{edge:.6g}"),)
                        lines.append(
                            f"{self._series(name + '_bucket', ll)} {cum}")
                ll = labels + (("le", "+Inf"),)
                lines.append(f"{self._series(name + '_bucket', ll)} "
                             f"{snap['count']}")
                lines.append(f"{self._series(name + '_sum', labels)} "
                             f"{snap['sum']}")
                lines.append(f"{self._series(name + '_count', labels)} "
                             f"{snap['count']}")
        return "\n".join(lines) + "\n"


# --------------------------------------------------------------- global
# The process-wide registry.  Hot paths read this module attribute once
# and branch on None — the entire disabled-mode cost.
ACTIVE: MetricsRegistry | None = None


def enable_metrics(registry: MetricsRegistry | None = None,
                   ) -> MetricsRegistry:
    """Arm the process-wide registry (idempotent; pass ``registry`` to
    install a specific instance, e.g. a fresh one in tests)."""
    global ACTIVE
    if registry is not None:
        ACTIVE = registry
    elif ACTIVE is None:
        ACTIVE = MetricsRegistry()
    return ACTIVE


def disable_metrics() -> None:
    global ACTIVE
    ACTIVE = None


def metrics() -> MetricsRegistry | None:
    """The active registry, or None when metrics are disabled."""
    return ACTIVE
