"""``repro_torch.core.serving`` against ``repro.core.serving`` on the CPU:
the batcher's pow-2 buckets, and ``MappingService`` on the same requests
— per-request results in every field, the totals, admission (``block``
and ``shed``), deadlines, ``submit_paired``, an injected ``flush`` fault,
a poisoned row quarantined per request, the tenant gauges and the
service's metrics, and the service on a one-shard mesh — then
``launch.serve``: ``--service`` on the CPU against the reference's
``run_service``, and its mesh modes (the distributed mode, ``--service
--topology mesh`` and ``--shards`` off the mesh) against the reference
CLI run as a subprocess with its host devices forced.

The world: an 8 kb genome and 64 reads of 150 bases, the reference's
service tests' own, on buckets of 8 to 32 reads."""
import argparse
import time

import numpy as np
import pytest

from repro.core import resilience as jres
from repro.core import serving as jsrv
from repro.core.index import build_index as jbuild
from repro.core.pipeline import MapperConfig as JConfig
from repro.data.genome import make_reference, sample_reads
from repro.obs import registry as jreg
from repro_torch.core import resilience as tres
from repro_torch.core import serving as tsrv
from repro_torch.core.index import GenomeIndex
from repro_torch.core.mapper import Mapper
from repro_torch.core.pipeline import MapperConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.obs import registry as treg

FIELDS = ("position", "distance", "distance2", "mapped", "strand", "ops",
          "op_count", "n_candidates", "linear_dist", "failed")
FAST = dict(max_attempts=2, backoff_s=0.0, bisect_min=4, degrade_after=1)


@pytest.fixture(autouse=True)
def _clean_obs():
    yield
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
    rs = sample_reads(ref, 64, seed=13, both_strands=True)
    return jidx, tidx, rs.reads


def services(world, engine="compacted", retry=None, **kw):
    """The reference's and the port's service on the same configuration;
    ``kw`` (``admission``, ``injector`` as a spec) for both."""
    jidx, tidx, _ = world
    spec = kw.pop("injector", None)
    adm = kw.pop("admission", None)
    out = []
    for mod, srv, idx, cfg in (
            (jres, jsrv, jidx, JConfig(engine=engine, both_strands=True)),
            (tres, tsrv, tidx, MapperConfig(engine=engine,
                                            both_strands=True))):
        extra = dict(retry=mod.RetryPolicy(**(retry or FAST)))
        if spec is not None:
            extra["injector"] = mod.FaultInjector.from_spec(spec)
        if adm is not None:
            extra["admission"] = mod.AdmissionConfig(**adm)
        if srv is tsrv:
            extra["device"] = "cpu"
        out.append(srv.MappingService(
            idx, cfg, srv.BatcherConfig(bucket_min=8, bucket_max=32),
            **extra))
    return out


def same_resolution(got, want):
    assert type(got).__name__ == type(want).__name__
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            same_resolution(g, w)
    elif isinstance(want, jres.MappingError):
        assert (got.error_type, got.message, got.n_reads) == \
            (want.error_type, want.message, want.n_reads)
    else:
        for f in FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if b is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)


def drive(svcs, script):
    """Run ``script(svc)`` on the reference's service and on the port's;
    each flush's results, the totals and the batcher's stats must
    agree."""
    jout, tout = (script(svc) for svc in svcs)
    js, ts = svcs
    for want, got in zip(jout, tout):
        assert sorted(got) == sorted(want)
        for rid in want:
            same_resolution(got[rid], want[rid])
    assert ts.totals == js.totals
    assert ts.batcher.stats == js.batcher.stats
    return jout, tout


# --------------------------------------------------------------- batcher

@pytest.mark.parametrize("kw", [dict(bucket_min=48), dict(bucket_max=0),
                                dict(bucket_min=128, bucket_max=64)])
def test_batcher_config_refuses_as_the_reference(kw):
    with pytest.raises(ValueError) as want:
        jsrv.BatcherConfig(**kw)
    with pytest.raises(ValueError) as got:
        tsrv.BatcherConfig(**kw)
    assert str(got.value) == str(want.value)


def test_pow2_buckets_and_drain_match_reference():
    for n in (1, 7, 8, 9, 31, 32, 33, 100, 1000):
        assert tsrv.pow2_buckets(n, lo=8, hi=32) == \
            jsrv.pow2_buckets(n, lo=8, hi=32)
    cfg = dict(bucket_min=64, bucket_max=1024)
    tb = tsrv.ReadBatcher(150, tsrv.BatcherConfig(**cfg))
    jb = jsrv.ReadBatcher(150, jsrv.BatcherConfig(**cfg))
    rng = np.random.default_rng(0)
    for _ in range(20):
        reqs = [np.zeros((int(rng.integers(1, 900)), 150), np.uint8)
                for _ in range(int(rng.integers(1, 4)))]
        for b in (tb, jb):
            for r in reqs:
                b.submit(r)
        (_, tbk, tsp), (_, jbk, jsp) = tb.drain(), jb.drain()
        assert (tbk, tsp) == (jbk, jsp)
    assert tb.stats == jb.stats and len(tb.stats["bucket_hist"]) <= 5
    with pytest.raises(ValueError, match="empty read batch"):
        tb.submit(np.zeros((0, 150), np.uint8))
    with pytest.raises(ValueError, match=r"expected \(n, 150\)"):
        tb.submit(np.zeros((3, 100), np.uint8))


# --------------------------------------------------------------- service

@pytest.mark.parametrize("engine", ["compacted", "fused"])
def test_service_matches_reference(world, engine):
    """Requests of 1 to 40 reads over three flushes: full buckets and
    residues, each request's slice equal to the reference's."""
    reads = world[2]
    flushes = [[(0, 5), (5, 18), (18, 19)], [(19, 51), (51, 58)],
               [(0, 40), (40, 64)]]

    def script(svc):
        out = []
        for spans in flushes:
            for lo, hi in spans:
                svc.submit(reads[lo:hi])
            out.append(svc.flush())
        assert svc.flush() == {}
        return out
    js, ts = services(world, engine)
    jout, tout = drive((js, ts), script)
    assert ts.mapper.plan_cache_misses == js.mapper.plan_cache_misses
    assert ts.affine_drop_rate == js.affine_drop_rate == 0.0


def test_admission_shed_and_block(world):
    reads = world[2]

    def shed(svc):
        svc.submit(reads[:10])
        with pytest.raises(Exception, match="resubmit after a flush"):
            svc.submit(reads[10:20])
        first = svc.flush()
        svc.submit(reads[:32])        # oversize against an empty queue
        return [first, svc.flush()]
    drive(services(world, admission=dict(max_pending_reads=16,
                                         policy="shed")), shed)

    def block(svc):
        r0 = svc.submit(reads[:10])
        r1 = svc.submit(reads[10:20])  # overflow: r0 drained, held
        assert svc.batcher.pending_reads == 10
        out = svc.flush()
        assert set(out) == {r0, r1}
        return [out]
    drive(services(world, admission=dict(max_pending_reads=16,
                                         policy="block")), block)


def test_deadline_expiry_resolves_to_error(world):
    reads = world[2]

    def script(svc):
        svc.submit(reads[:8], deadline_s=0.01)
        svc.submit(reads[8:20])
        time.sleep(0.03)
        out = svc.flush()
        # the message carries the lateness; hold the rest of it
        err = out[0]
        assert err.error_type == "deadline" and err.n_reads == 8
        out[0] = tres.MappingError("deadline", "late", n_reads=8) \
            if isinstance(err, tres.MappingError) else \
            jres.MappingError("deadline", "late", n_reads=8)
        return [out]
    js, ts = services(world)
    drive((js, ts), script)
    assert ts.totals["deadline_misses"] == 1
    with pytest.raises(ValueError, match="deadline_s"):
        ts.submit(reads[:2], deadline_s=0)


def test_submit_paired_and_poisoned_rows(world):
    """Paired requests come back per mate; a poisoned row quarantines its
    block in one request and leaves the others mapped."""
    reads = world[2]

    def script(svc):
        svc.submit_paired(reads[:8], reads[8:16])
        svc.submit(reads[16:28])
        svc.submit_paired(reads[28:40], reads[40:52])
        with pytest.raises(ValueError, match="pairwise"):
            svc.submit_paired(reads[:2], reads[:3])
        return [svc.flush()]
    js, ts = services(world, injector="poison=2;33,seed=0")
    jout, tout = drive((js, ts), script)
    r1, r2 = tout[0][0]
    assert r1.failed is not None and r1.failed.any()
    assert r2.failed is None or not r2.failed.any()
    assert ts.totals["failed_reads"] > 0


def test_flush_fault_resolves_every_request(world):
    reads = world[2]

    def script(svc):
        rids = [svc.submit(reads[:10]), svc.submit(reads[10:20])]
        out = svc.flush()
        assert sorted(out) == rids
        assert all(o.error_type == "internal" and "InjectedFault" in
                   o.message for o in out.values())
        return [out, svc.flush()]
    js, ts = services(world, injector="flush=1")
    drive((js, ts), script)
    assert ts.totals["failed_requests"] == 2


def test_service_metrics_and_tenant_bound(world):
    """The tenant gauges, request counters and the flush's histograms:
    the reference's series, with its counts (times aside)."""
    reads = world[2]
    jr = jreg.enable_metrics(jreg.MetricsRegistry())
    tr = treg.enable_metrics(treg.MetricsRegistry())
    n = tsrv._MAX_TENANTS + 8

    def script(svc):
        for i in range(n):
            svc.submit(reads[i % len(reads)][None], tenant=f"tenant{i}")
        assert svc.tenant_queue_depth["_other"] == 8
        out = svc.flush()
        assert not svc._submit_ts and not svc._tenants
        assert all(d == 0 for d in svc._tenant_pending.values())
        return [out]
    drive(services(world), script)
    js, ts = jr.snapshot(), tr.snapshot()

    def strip(snap):
        return ({k: v for k, v in snap["counters"].items()
                 if not k.startswith("repro_stage_seconds")},
                snap["gauges"],
                {k: v["count"] for k, v in snap["histograms"].items()})
    assert strip(ts) == strip(js)
    assert ts["histograms"]["repro_request_queue_wait_seconds"]["count"] == n


# -------------------------------------------------------------- launcher

def _serve_args(**kw):
    args = dict(service=True, topology="single", shards=None, genome=20_000,
                reads=96, batches=2, send_cap=None, bucket_min=64,
                bucket_max=128, no_stream=False, trace_out=None,
                metrics_out=None, metrics_port=None, profiler_port=None,
                log_json=False)
    args.update(kw)
    return argparse.Namespace(**args)


def test_serve_service_matches_reference(capsys, tmp_path):
    from repro.launch import serve as ref_serve
    assert ref_serve.run_service(_serve_args(wf_backend="jnp")) == 0
    want = capsys.readouterr().out.splitlines()
    argv = ["--service", "--genome", "20000", "--reads", "96",
            "--batches", "2", "--bucket-max", "128", "--device", "cpu",
            "--metrics-out", str(tmp_path / "m.jsonl"),
            "--profiler-port", "9"]
    assert serve_cli.main(argv) == 0
    cap = capsys.readouterr()
    got = cap.out.splitlines()
    # the request count, accuracy, bucket histogram and the closing stats
    # lines (not the wall times or the start line's device); the index
    # storage line's hash table counts the port's int64 offsets and
    # positions (a documented difference), its segment bytes are equal
    assert got[1].split(" in ")[0] == want[1].split(" in ")[0]
    assert got[1].split("accuracy")[1] == want[1].split("accuracy")[1]
    assert got[2:-1] == want[2:-1]
    assert got[-1].split(" B,")[0].split("+")[1] == \
        want[-1].split(" B,")[0].split("+")[1]
    assert "torch profiler server unavailable" in cap.err
    assert (tmp_path / "m.jsonl").read_text().count("\n") == 1


SERVE_SMALL = ["--genome", "20000", "--reads", "64", "--batches", "2",
               "--bucket-max", "128"]


def _timeless(line):
    """A closing line without its wall time and rate."""
    return line.split(" in ")[0] + (
        " accuracy" + line.split("accuracy")[1] if "accuracy" in line
        else "")


@pytest.mark.parametrize("argv", [["--shards", "2"],
                                  ["--service", "--topology", "mesh",
                                   "--shards", "2"],
                                  ["--service", "--shards", "4"]],
                         ids=["distributed", "service_mesh",
                              "service_shards"])
def test_serve_mesh_modes_match_reference(argv, capsys):
    """The distributed mode, the service on the mesh, and ``--shards``
    ignored by the single-topology service: the reference CLI's lines
    apart from the wall times and the start line's device; the index
    storage line's hash table counts the port's int64 offsets and
    positions (a documented difference), its segment bytes are equal."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    env.pop("XLA_FLAGS", None)      # the reference CLI sets its own
    proc = subprocess.run([sys.executable, "-m", "repro.launch.serve",
                           *argv, *SERVE_SMALL, "--wf-backend", "jnp"],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = proc.stdout.splitlines()
    assert serve_cli.main(argv + SERVE_SMALL + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    # the start line: the service's names its backend and device
    assert got[0].split(", wf_backend")[0] == want[0].split(", wf_backend")[0]
    assert _timeless(got[1]) == _timeless(want[1])
    assert got[2:-1] == want[2:-1]
    assert got[-1].split(" B,")[0].split("+")[1] == \
        want[-1].split(" B,")[0].split("+")[1]
    if "mesh" in argv or "--service" not in argv:
        assert any(ln.startswith("stage B [mesh]:") for ln in got)


def test_mesh_service_matches_reference(world):
    """``MappingService`` on a one-shard mesh session: each bucket one
    mesh batch planned at its bucket size, every request's fields, the
    totals and the plan-cache counters equal the reference's."""
    from repro.core.mapper import Mapper as JMapper
    jidx, tidx, reads = world
    bc = dict(bucket_min=8, bucket_max=32)
    jm = JMapper(jidx, JConfig.from_index(jidx, both_strands=True),
                 topology="mesh", n_shards=1)
    tm = Mapper(tidx, MapperConfig.from_index(tidx, both_strands=True),
                topology="mesh", device="cpu")
    js = jsrv.MappingService(jm, batcher=jsrv.BatcherConfig(**bc))
    ts = tsrv.MappingService(tm, batcher=tsrv.BatcherConfig(**bc))
    for _ in range(2):
        sizes = (40, 3, 21)
        jr, tr = [], []
        lo = 0
        for n in sizes:
            jr.append(js.submit(reads[lo:lo + n]))
            tr.append(ts.submit(reads[lo:lo + n]))
            lo += n
        jout, tout = js.flush(), ts.flush()
        for a, b in zip(jr, tr):
            for f in ("position", "distance", "distance2", "mapped",
                      "strand"):
                np.testing.assert_array_equal(getattr(tout[b], f),
                                              getattr(jout[a], f), f)
        assert (tm.plan_cache_hits, tm.plan_cache_misses) == \
            (jm.plan_cache_hits, jm.plan_cache_misses)
    assert ts.totals == js.totals
    assert tm.plan_cache_hits > 0
