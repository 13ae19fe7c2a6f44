"""The port's span hook (``repro_torch.obs.tracing.span``) on the mapper's
hot path, on the CPU: nothing records and the results are the same bit
for bit where nobody looks; under ``torch.profiler`` every span of the
chunk schedule reaches the profiler's trace as a user annotation and the
profile's own record (``profiled()``) with its call, chunk and parent, as
it reaches an armed tracer; ``d2h`` and ``h2d`` carry the bytes of the
arrays they copy; the ``sync`` spans are the host reads of device counts,
site by site; a new profile starts a fresh record; the registry's
counters read the same numbers."""
import collections
import json

import numpy as np
import pytest
import torch

from repro.data.genome import make_reference, sample_pairs, sample_reads
from repro_torch.core.index import build_index
from repro_torch.core.mapper import Mapper
from repro_torch.core.pairing import resolve_pairs
from repro_torch.core.pipeline import MapperConfig
from repro_torch.obs import registry as treg
from repro_torch.obs import tracing as ttrace

GEOM = dict(read_len=60, k=10, w=12, eth=4)
CHUNK = 16
# the spans of one chunk on the caller's thread, by engine, beside the
# run's mapper.run, fetch_wait (one a chunk) and assemble (one a run)
STAGES = {"compacted": ("host_prep", "h2d", "seed", "linear", "affine",
                        "traceback"),
          "fused": ("host_prep", "h2d", "seed", "fused")}
# sync sites a full chunk reads; a partial one adds the *_real counts
SITES = {"compacted": ("n_valid", "survivors"), "fused": ("n_valid",)}
RESULT_FIELDS = ("position", "distance", "distance2", "mapped", "strand",
                 "ops", "op_count", "linear_dist", "n_candidates")


@pytest.fixture(autouse=True)
def _clean_obs():
    yield
    ttrace.disable_tracing()
    ttrace.clear_ctx()
    treg.disable_metrics()


@pytest.fixture(scope="module")
def world():
    ref = make_reference(8_000, seed=11, repeat_frac=0.03)
    idx = build_index(ref, **GEOM, device="cpu")
    reads = sample_reads(ref, 40, read_len=GEOM["read_len"], seed=13,
                         both_strands=True).reads
    return ref, idx, reads


def _mapper(idx, **kw):
    return Mapper(idx, MapperConfig.from_index(idx, chunk_reads=CHUNK,
                                               **kw), device="cpu")


def _all_threads_profile():
    """A CPU profile of every thread, the fetch thread's included."""
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))


def _same(a, b):
    for f in RESULT_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_off_span_is_one_shared_null_context():
    assert not ttrace.recording()
    a, b = ttrace.span("seed"), ttrace.span("sync", site="n_valid")
    assert a is b
    with a as sp:
        assert sp is None
    # a stage span handed a dict times itself with nothing recording
    times = {}
    with ttrace.span("seed", times) as sp:
        assert sp is not None
    assert times["seed"] > 0 and not ttrace.recording()


@pytest.mark.parametrize("engine", ["compacted", "fused"])
def test_nothing_records_unwatched_and_results_are_the_same(world, engine):
    _, idx, reads = world
    m = _mapper(idx, engine=engine, both_strands=True)
    before = ttrace.profiled()
    n_before = len(before) if before is not None else 0
    plain = m.map(reads)
    assert ttrace.tracer() is None and ttrace.profiled() is before
    assert (len(before) if before is not None else 0) == n_before
    assert "stage_times_s" not in plain.stats
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        watched = m.map(reads)
    tr = ttrace.enable_tracing(tracer_=ttrace.Tracer())
    traced = m.map(reads)
    assert len(tr) > 0
    _same(plain, watched)
    _same(plain, traced)


def _check_record(spans, engine, n_chunks):
    """Every span of one streamed run: one mapper.run, the engine's
    stages, syncs and fetch_wait once a chunk under it, d2h once a chunk
    on the fetch thread; all carry the run's call, the chunk spans their
    chunk."""
    runs = [s for s in spans if s.name == "mapper.run"]
    assert len(runs) == 1
    run = runs[0]
    assert run.parent is None and run.args["call"] == run.sid
    count = collections.Counter(s.name for s in spans)
    for name in STAGES[engine] + ("fetch_wait", "d2h"):
        assert count[name] == n_chunks, name
    assert count["assemble"] == 1
    for s in spans:
        assert s.args["call"] == run.sid, s
        if s.name == "d2h":
            assert s.parent is None and s.thread != run.thread
        elif s.name != "mapper.run":
            assert s.parent == run.sid and s.thread == run.thread, s
        if s.name in STAGES[engine] + ("fetch_wait", "d2h", "sync"):
            assert 0 <= s.args["chunk"] < n_chunks, s
    for name in STAGES[engine] + ("d2h",):
        assert sorted(s.args["chunk"] for s in spans
                      if s.name == name) == list(range(n_chunks))


@pytest.mark.parametrize("engine", ["compacted", "fused"])
def test_profiler_trace_and_record_hold_every_span(world, engine, tmp_path):
    """Under ``torch.profiler`` each span is a user annotation of the
    trace (the fetch thread's ``d2h`` where the profile takes every
    thread) and a span of ``profiled()``; an armed tracer gets the same
    spans."""
    _, idx, reads = world
    m = _mapper(idx, engine=engine, both_strands=True)
    n_chunks = -(-len(reads) // CHUNK)
    with _all_threads_profile() as prof:
        m.map(reads)
    rec = ttrace.profiled().spans()
    _check_record(rec, engine, n_chunks)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    annotated = collections.Counter(
        e["name"] for e in events if e.get("cat") == "user_annotation")
    assert annotated == collections.Counter(s.name for s in rec)

    tr = ttrace.enable_tracing(tracer_=ttrace.Tracer())
    m.map(reads)
    armed = tr.spans()
    _check_record(armed, engine, n_chunks)
    assert collections.Counter(s.name for s in armed) == \
        collections.Counter(s.name for s in rec)
    chrome = [e for e in tr.chrome()["traceEvents"] if e["ph"] == "X"]
    assert {e["args"]["parent"] for e in chrome
            if e["name"] == "seed"} == {armed[-1].sid}


def test_pairing_spans(world):
    ref, idx, _ = world
    pairs = sample_pairs(ref, 24, read_len=GEOM["read_len"],
                         insert_mean=200.0, seed=7)
    r2 = pairs.reads2.copy()
    r2[:6] = np.random.default_rng(3).integers(0, 4, r2[:6].shape)
    m = _mapper(idx, both_strands=True)
    res1, res2 = m.map_pairs(pairs.reads1, r2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        resolve_pairs(res1, res2, cfg=m.cfg, ref=ref, reads1=pairs.reads1,
                      reads2=r2, device="cpu")
    spans = {s.name: s for s in ttrace.profiled().spans()}
    assert set(spans) == {"resolve_pairs", "rescue"}
    top, rescue = spans["resolve_pairs"], spans["rescue"]
    assert top.args["pairs"] == 24 and top.parent is None
    assert rescue.parent == top.sid and rescue.args["mates"] >= 1
    assert top.t0 <= rescue.t0 <= rescue.t1 <= top.t1
    assert {"resolve_pairs", "rescue"} <= {e.name for e in prof.events()}


@pytest.mark.parametrize("engine,both", [("compacted", False),
                                         ("fused", True)])
def test_copy_bytes_are_the_arrays_copied(world, engine, both):
    """``d2h`` bytes are the fetched host arrays' (whole chunks: no
    trim) plus the chunk's count tensors (the fused engine's survivors,
    the strand fold's ``reverse_best``: int64 each); ``h2d`` bytes the
    uploaded reads."""
    _, idx, reads = world
    reads = reads[:2 * CHUNK]
    tr = ttrace.enable_tracing(tracer_=ttrace.Tracer())
    reg = treg.enable_metrics(treg.MetricsRegistry())
    res = _mapper(idx, engine=engine, both_strands=both).map(reads)
    spans = tr.spans()
    counts = (engine == "fused") + both
    want = sum(getattr(res, f).nbytes for f in RESULT_FIELDS
               if getattr(res, f) is not None) + 2 * 8 * counts
    d2h = [s.args for s in spans if s.name == "d2h"]
    assert sum(a["bytes"] for a in d2h) == want
    assert all(a["pageable"] for a in d2h)
    fields = sum(getattr(res, f) is not None for f in RESULT_FIELDS)
    assert {a["copies"] for a in d2h} == {fields + counts}
    h2d = [s.args for s in spans if s.name == "h2d"]
    assert [a["bytes"] for a in h2d] == \
        [CHUNK * GEOM["read_len"] * (1 + both)] * 2
    snap = reg.snapshot()["counters"]
    assert snap['repro_d2h_bytes_total{memory="pageable"}'] == want
    assert snap['repro_h2d_bytes_total{memory="pageable"}'] == \
        sum(a["bytes"] for a in h2d)


@pytest.mark.parametrize("engine,cigar_mode", [("compacted", "eager"),
                                               ("fused", "lazy")])
def test_fetch_places_the_results_and_assemble_copies_nothing(
        world, engine, cigar_mode):
    """Each chunk's ``d2h`` writes its real rows straight into the call's
    result arrays: the spans' ``placed`` sums to the result arrays' bytes
    (the lazy traceback's held arrays among them; a partial last chunk's
    padding left behind), their ``bytes`` add only the count tensors, and
    ``assemble`` copies no bytes."""
    _, idx, reads = world
    reads = reads[:2 * CHUNK + 5]
    tr = ttrace.enable_tracing(tracer_=ttrace.Tracer())
    res = _mapper(idx, engine=engine, both_strands=True,
                  cigar_mode=cigar_mode).map(reads)
    spans = tr.spans()
    lt = res.lazy_tb
    if lt is None:
        fetched = [getattr(res, f) for f in RESULT_FIELDS]
    else:       # ops and op_count come later, from the deferred traceback
        fetched = [getattr(res, f) for f in RESULT_FIELDS
                   if f not in ("ops", "op_count")]
        fetched += [lt.reads, lt.occ, lt.mpos]
    want = sum(a.nbytes for a in fetched if a is not None)
    d2h = [s.args for s in spans if s.name == "d2h"]
    assert len(d2h) == 3
    assert sum(a["placed"] for a in d2h) == want
    counts = (engine == "fused") + 1        # survivors, reverse_best
    assert [a["bytes"] - a["placed"] for a in d2h] == [8 * counts] * 3
    assert [s.args["bytes"] for s in spans if s.name == "assemble"] == [0]


@pytest.mark.parametrize("engine", ["compacted", "fused"])
@pytest.mark.parametrize("both", [False, True])
def test_syncs_are_the_listed_sites(world, engine, both):
    """One ``sync`` span a host read of a device count: the listed sites a
    full chunk, the ``*_real`` counts beside them on the partial last
    chunk; the registry counts the same by site."""
    _, idx, reads = world
    n = 2 * CHUNK + 5
    tr = ttrace.enable_tracing(tracer_=ttrace.Tracer())
    reg = treg.enable_metrics(treg.MetricsRegistry())
    _mapper(idx, engine=engine, both_strands=both).map(reads[:n])
    by_chunk = collections.defaultdict(list)
    for s in tr.spans():
        if s.name == "sync":
            by_chunk[s.args["chunk"]].append(s.args["site"])
    full = list(SITES[engine])
    partial = [x for site in full for x in (site, site + "_real")]
    assert dict(by_chunk) == {0: full, 1: full, 2: partial}
    snap = reg.snapshot()["counters"]
    for site in partial:
        assert snap[f'repro_device_syncs_total{{site="{site}"}}'] == \
            (3 if site in full else 1)


def test_profiled_stage_times_equal_the_spans(world):
    """``profile=True`` on the streamed path fills ``stage_times_s`` from
    the stage spans: each equals the armed tracer's total of its name."""
    _, idx, reads = world
    tr = ttrace.enable_tracing(tracer_=ttrace.Tracer())
    res = _mapper(idx, profile=True, both_strands=True).map(reads)
    st = res.stats["stage_times_s"]
    totals = tr.stage_totals()
    assert set(st) == set(STAGES["compacted"]) | {"d2h"}
    assert st == {k: totals[k] for k in st}


def test_each_profile_starts_a_fresh_record(world):
    _, idx, reads = world
    m = _mapper(idx)
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu):
        m.map(reads)
    first = ttrace.profiled()
    assert len([s for s in first.spans() if s.name == "mapper.run"]) == 1
    with torch.profiler.profile(activities=cpu):
        m.map(reads[:CHUNK])
        m.map(reads[:CHUNK])
    second = ttrace.profiled()
    assert second is not first
    runs = [s for s in second.spans() if s.name == "mapper.run"]
    assert [r.args["reads"] for r in runs] == [CHUNK, CHUNK]
    # still readable after the profile, and nothing added since
    n = len(second)
    m.map(reads)
    assert ttrace.profiled() is second and len(second) == n
    with torch.profiler.profile(activities=cpu):
        pass
    assert ttrace.profiled() is not second and len(ttrace.profiled()) == 0


def test_mesh_stages_take_the_common_names(world):
    _, idx, reads = world
    tr = ttrace.enable_tracing(tracer_=ttrace.Tracer())
    res = Mapper(idx, MapperConfig.from_index(idx), topology="mesh",
                 n_shards=2, device="cpu").map(reads)
    names = [s.name for s in tr.spans()]
    assert names == ["dispatch", "d2h", "mapper.run"]
    assert set(res.stats["stage_times_s"]) == {"dispatch", "d2h"}
    d2h = tr.spans()[1].args
    assert d2h["bytes"] > 0 and d2h["copies"] == 6
