"""``repro_torch.obs`` against ``repro.obs`` on the CPU: the registry,
tracer, JSON log and validators give the reference's snapshot,
Prometheus text, Chrome trace events and log lines on the same calls
(timestamps aside); ``streaming.timed`` feeds ``stage_times_s``, the
trace and the stage counters from the same clock reads, so a
``stream=False`` run's span durations equal its ``stage_times_s``;
``totals_from_registry`` equals ``accumulate_stats`` and the reference's
registry; the index build's and the residency arena's counters and spans
carry the reference's names and values; a snapshot validates against
``schemas/metrics_snapshot.schema.json``."""
import io
import json
import os
import threading
import time

import pytest
import torch

from repro.core.index import build_index as jbuild
from repro.core.mapper import Mapper as JMapper
from repro.core.mapper import totals_from_registry as j_totals
from repro.core.pipeline import MapperConfig as JConfig
from repro.data.genome import make_reference, sample_reads, write_fasta
from repro.index import build_sharded_index as ref_build
from repro.index import open_index as ref_open
from repro.obs import logjson as jlog
from repro.obs import registry as jreg
from repro.obs import tracing as jtrace
from repro.obs import validate as jval
from repro_torch.core import streaming
from repro_torch.core.index import GenomeIndex
from repro_torch.core.mapper import (_METRIC_RUN_FIELDS, Mapper,
                                     accumulate_stats, totals_from_registry)
from repro_torch.core.pipeline import MapperConfig
from repro_torch.index import build_sharded_index, open_index
from repro_torch.obs import logjson as tlog
from repro_torch.obs import registry as treg
from repro_torch.obs import server as tserver
from repro_torch.obs import tracing as ttrace
from repro_torch.obs import validate as tval

SCHEMA = os.path.join(os.path.dirname(__file__), "..", "schemas",
                      "metrics_snapshot.schema.json")
GEOM = dict(read_len=60, k=10, w=12, eth=4)


@pytest.fixture(autouse=True)
def _clean_obs():
    """Obs state is process-global: never leak an armed registry, tracer
    or span context into another test."""
    yield
    for mod in (jtrace, ttrace):
        mod.disable_tracing()
        mod.clear_ctx()
    jreg.disable_metrics()
    treg.disable_metrics()


@pytest.fixture(scope="module")
def world():
    ref = make_reference(8_000, seed=11, repeat_frac=0.03)
    jidx = jbuild(ref)
    tidx = GenomeIndex.from_arrays(jidx.uniq_kmers, jidx.offsets,
                                   jidx.positions, jidx.segments,
                                   read_len=jidx.read_len, k=jidx.k,
                                   w=jidx.w, eth=jidx.eth)
    rs = sample_reads(ref, 48, seed=13, both_strands=True)
    return jidx, tidx, rs.reads


def without_timing(snap):
    """A snapshot with the wall-time series and values taken out."""
    return ({k: v for k, v in snap["counters"].items()
             if not k.startswith("repro_stage_seconds")},
            snap["gauges"],
            {k: v["count"] for k, v in snap["histograms"].items()})


# ---------------------------------------------------------------- registry

def drive_registry(reg):
    reg.counter("c_total").inc()
    reg.counter("c_total").inc(4)
    reg.counter("req_total", code="200").inc(3)
    reg.gauge("g", shard="0").set(7)
    reg.gauge("g", shard="0").dec(2)
    reg.gauge("depth").inc(2.5)
    h = reg.histogram("lat_seconds")
    for v in (0.001, 0.002, 0.004, 0.1, 2.0, 1e9, 3e-7):
        h.observe(v)
    for i in range(reg.max_label_sets * 2):
        reg.counter("hot_total", tenant=f"t{i}").inc()
    with pytest.raises(ValueError, match="is a counter"):
        reg.gauge("c_total")
    return h


def test_registry_matches_reference():
    t, j = treg.MetricsRegistry(), jreg.MetricsRegistry()
    th, jh = drive_registry(t), drive_registry(j)
    assert t.snapshot() == j.snapshot()
    assert t.to_prometheus() == j.to_prometheus()
    assert [th.quantile(q) for q in (0.1, 0.5, 0.99)] == \
        [jh.quantile(q) for q in (0.1, 0.5, 0.99)]
    assert treg.DEFAULT_BUCKET_EDGES == jreg.DEFAULT_BUCKET_EDGES
    series = [k for k in t.snapshot()["counters"] if k.startswith("hot")]
    assert len(series) == treg.MAX_LABEL_SETS + 1 == jreg.MAX_LABEL_SETS + 1
    assert treg.metrics() is None
    assert treg.enable_metrics() is treg.enable_metrics() is treg.metrics()


# ----------------------------------------------------------------- tracing

def drive_tracer(tr, mod):
    mod.set_ctx(chunk=3)
    tr.add("work", tr.epoch + 0.5, tr.epoch + 0.75, {"shard": 1})
    mod.clear_ctx()
    tr.add("seed", tr.epoch + 1.0, tr.epoch + 1.5)
    tr.add("seed", tr.epoch + 2.0, tr.epoch + 2.25)
    side = threading.Thread(target=tr.add,
                            args=("d2h", tr.epoch + 3.0, tr.epoch + 3.5))
    side.start()
    side.join(timeout=10)
    for _ in range(5):
        tr.add("drop", tr.epoch, tr.epoch + 1.0)


def test_tracer_chrome_events_match_reference():
    t, j = ttrace.Tracer(max_events=7), jtrace.Tracer(max_events=7)
    t.epoch = j.epoch
    drive_tracer(t, ttrace)
    drive_tracer(j, jtrace)
    assert t.chrome() == j.chrome()
    assert t.chrome()["dropped_events"] == 2
    assert t.stage_totals() == j.stage_totals()
    assert tval.validate_chrome_trace(t.chrome()) == []
    with t.span("timed", stage=2):
        pass
    assert t.dropped == 3 and len(t) == 7


def test_annotate_and_profiler_server():
    """``annotate`` is a null context until a tracer is armed, then a
    ``torch.profiler.record_function``; the profiler server is the
    reference's "unavailable" answer."""
    ctx = ttrace.annotate("seed_dispatch")
    assert not isinstance(ctx, torch.profiler.record_function)
    with ctx:
        pass
    ttrace.enable_tracing()
    ctx = ttrace.annotate("seed_dispatch")
    assert isinstance(ctx, torch.profiler.record_function)
    with torch.profiler.profile() as prof, ctx:
        torch.ones(4).sum()
    assert any(e.name == "seed_dispatch" for e in prof.events())
    assert tserver.start_profiler_server(0) is None


def test_metrics_server_round_trip():
    import urllib.request
    reg = treg.MetricsRegistry()
    reg.counter("up_total").inc()
    srv = tserver.start_metrics_server(reg, port=0)
    try:
        base = f"http://{srv.host}:{srv.port}"
        text = urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert text == reg.to_prometheus()
        snap = json.loads(
            urllib.request.urlopen(f"{base}/metrics.json").read())
        assert snap == reg.snapshot()
    finally:
        srv.stop()


# ------------------------------------------------------------------ logjson

def test_logjson_matches_reference(capsys):
    lines = []
    for mod in (jlog, tlog):
        buf = io.StringIO()
        assert not mod.emit("start")           # off: nothing written
        mod.say("plain line")                  # off: a print to stderr
        mod.enable("map_fastq", stream=buf)
        assert mod.enabled()
        mod.say("chunk 0: 16 reads", event="chunk", chunk=0, reads=16)
        mod.emit("done", reads=16, wall_s=0.5, path=os.path)
        mod.disable()
        recs = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        for r in recs:
            assert r.pop("ts_unix_s") > 0
        lines.append(recs)
    assert lines[0] == lines[1] and len(lines[0]) == 2
    assert capsys.readouterr().err == "plain line\nplain line\n"


# --------------------------------------------------------------- validators

CASES = [
    {"traceEvents": []},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 0,
                      "ts": 0.0}]},
    {"traceEvents": [{"ph": "B", "name": "a", "pid": 1, "tid": 0,
                      "ts": 0.0}]},
    {"traceEvents": [{"ph": "E", "name": "a", "pid": 1, "tid": 0,
                      "ts": 0.0}, {"ph": "X", "name": "b", "pid": "1",
                                   "tid": 0, "ts": 0, "dur": -1}]},
    [{"ph": "M", "pid": 1}, 3, {"name": "x"}],
    "not a trace",
]


def test_validators_match_reference(tmp_path):
    for case in CASES:
        assert tval.validate_chrome_trace(case) == \
            jval.validate_chrome_trace(case)
    schema = tval.load_json(SCHEMA)
    for obj in ({"kind": "metrics_snapshot"}, {"seq": -1, "counters": 3},
                [], {"kind": "x", "seq": 0, "ts_unix_s": 1.0,
                     "counters": {}, "gauges": {}, "histograms": {}}):
        assert tval.validate_json(obj, schema) == \
            jval.validate_json(obj, schema)
    p = tmp_path / "m.jsonl"
    p.write_text('{"kind": 1}\nnot json\n\n')
    assert tval.validate_jsonl(p, schema) == jval.validate_jsonl(p, schema)
    (tmp_path / "e.jsonl").write_text("")
    assert tval.validate_jsonl(tmp_path / "e.jsonl", schema) == \
        ["no JSONL records"]


# ---------------------------------------------- timed() and stage times

def test_timed_feeds_times_span_and_counter_from_same_clock_reads():
    reg = treg.enable_metrics(treg.MetricsRegistry())
    tr = ttrace.enable_tracing(tracer_=ttrace.Tracer())
    times = {}
    t0 = time.perf_counter()
    assert streaming.timed(times, "stage_x", t0) >= t0
    assert tr.stage_totals()["stage_x"] == times["stage_x"]
    assert reg.counter("repro_stage_seconds_total",
                       stage="stage_x").value == times["stage_x"]
    streaming.timed(None, "stage_y", t0)   # profiling off: nothing
    assert len(tr) == 1


@pytest.mark.parametrize("cfg", [dict(stream=False, engine="compacted"),
                                 dict(stream=False, engine="fused"),
                                 dict(profile=True, engine="compacted")])
def test_trace_durations_equal_stage_times(world, cfg):
    """A traced run's summed span durations are its ``stage_times_s``:
    the same clock reads, so the equality is exact; the spans carry their
    chunk, and the dispatch annotations do not enter the trace."""
    _, tidx, reads = world
    tr = ttrace.enable_tracing(tracer_=ttrace.Tracer())
    res = Mapper(tidx, MapperConfig.from_index(tidx, chunk_reads=16, **cfg),
                 device="cpu").map(reads[:40])
    st = res.stats["stage_times_s"]
    assert tr.stage_totals() == st
    chunks = {e["args"]["chunk"] for e in tr.chrome()["traceEvents"]
              if e["ph"] == "X"}
    assert chunks == {0, 1, 2}


def test_registry_totals_match_accumulate_and_reference(world):
    """Per-run counters summed in the registry equal ``accumulate_stats``
    over the runs and the reference's registry on the same runs; so do
    the plan-cache counters."""
    jidx, tidx, reads = world
    jr = jreg.enable_metrics(jreg.MetricsRegistry())
    tr = treg.enable_metrics(treg.MetricsRegistry())
    assert totals_from_registry("single") == {f: 0
                                              for f in _METRIC_RUN_FIELDS}
    jm = JMapper(jidx, JConfig.from_index(jidx, chunk_reads=16,
                                          both_strands=True))
    tm = Mapper(tidx, MapperConfig.from_index(tidx, chunk_reads=16,
                                              both_strands=True),
                device="cpu")
    totals = {f: 0 for f in _METRIC_RUN_FIELDS}
    for lo in range(0, len(reads), 24):
        jm.map(reads[lo:lo + 24])
        accumulate_stats(totals, tm.map(reads[lo:lo + 24]).stats,
                         fields=_METRIC_RUN_FIELDS)
    assert totals_from_registry("single", tr) == totals == \
        j_totals("single", jr)
    assert without_timing(tr.snapshot()) == without_timing(jr.snapshot())
    assert tr.counter("repro_plan_cache_hits_total",
                      topology="single").value == 1
    treg.disable_metrics()
    assert totals_from_registry("single") is None


def test_snapshot_validates_against_schema(world, tmp_path):
    from repro_torch.obs.surfaces import metrics_snapshot
    _, tidx, reads = world
    treg.enable_metrics(treg.MetricsRegistry())
    cfg = MapperConfig.from_index(tidx, stream=False)
    Mapper(tidx, cfg, device="cpu").serve().submit(reads[:5])
    Mapper(tidx, cfg, device="cpu").map(reads[:8])
    path = tmp_path / "m.jsonl"
    metrics_snapshot(str(path), seq=0)
    metrics_snapshot(str(path), seq=1)
    metrics_snapshot(None, seq=2)          # no path: nothing written
    schema = tval.load_json(SCHEMA)
    assert tval.validate_jsonl(path, schema) == []
    assert jval.validate_jsonl(path, schema) == []
    assert len(path.read_text().splitlines()) == 2


# ------------------------------------------- the index build and the arena

def test_index_build_and_arena_metrics_match_reference(tmp_path):
    """The sharded build's counters and spans, then a routed run that
    evicts: the arena's counters, with the reference's names and
    values."""
    ref = make_reference(6000, seed=21, repeat_frac=0.02)
    write_fasta(tmp_path / "ref.fa", [("chr1", ref)])
    snaps, names = [], []
    for regmod, trmod, build in ((jreg, jtrace, ref_build),
                                 (treg, ttrace, build_sharded_index)):
        reg = regmod.enable_metrics(regmod.MetricsRegistry())
        tr = trmod.enable_tracing(tracer_=trmod.Tracer())
        kw = dict(device="cpu") if build is build_sharded_index else {}
        build(tmp_path / "ref.fa", tmp_path / build.__module__,
              num_partitions=32, tile_bp=1001, **GEOM, **kw)
        names.append(sorted({e["name"] for e in tr.chrome()["traceEvents"]
                             if e["ph"] == "X"}))
        snaps.append(reg.snapshot())
        regmod.disable_metrics()
        trmod.disable_tracing()
    assert names[0] == names[1] == ["index_partition", "index_scan"]
    assert snaps[0] == snaps[1]
    reads = sample_reads(ref, 8, read_len=60, seed=5,
                         both_strands=True).reads
    idx = open_index(tmp_path / "repro_torch.index.build")
    budget = sum(p.n_occurrences for p in idx.parts) // 2 * (idx.seg_len + 4)
    for regmod, (mapper, cfg, path, kw) in (
            (jreg, (JMapper, JConfig, "repro.index.build", {})),
            (treg, (Mapper, MapperConfig, "repro_torch.index.build",
                    dict(device="cpu")))):
        reg = regmod.enable_metrics(regmod.MetricsRegistry())
        idx = (ref_open if mapper is JMapper else open_index)(tmp_path / path)
        mapper(idx, cfg.from_index(idx, chunk_reads=1),
               memory_budget_bytes=budget, **kw).map(reads)
        snaps.append(without_timing(reg.snapshot()))
        regmod.disable_metrics()
    assert snaps[2] == snaps[3]
    assert snaps[3][0]["repro_partition_evictions_total"] > 0
