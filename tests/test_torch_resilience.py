"""``repro_torch.core.resilience`` against ``repro.core.resilience`` on the
CPU: the policy objects' validation, ``FaultInjector`` (the same sites
fire in the same order from the same spec), the ``DegradeLadder``
(``fused -> compacted``, the reference's ladder on ``jnp``: the port's
backend never steps down to the kernels' plain versions), and
``ResilientMapper`` on poisoned rows, a transient bucket rate and failing
engines: the same ``failed`` masks, counters, ladder levels and every
``MappingResult`` field.  Then the port's own rules: the kernels' errors
are not contained, a card session builds its kernels before the first
block and refuses a torch without ``torch.AcceleratorError``, and every
descent is written to stderr.

The world: an 8 kb genome and 64 reads of 150 bases, the reference's
resilience tests' own."""
import dataclasses
import signal
import time

import numpy as np
import pytest
import torch

from repro.core import resilience as jres
from repro.core.index import build_index as jbuild
from repro.core.mapper import Mapper as JMapper
from repro.core.pipeline import MapperConfig as JConfig
from repro.data.genome import make_reference, sample_reads
from repro.obs import registry as jreg
from repro_torch.core import resilience as tres
from repro_torch.core.index import GenomeIndex
from repro_torch.core.mapper import Mapper
from repro_torch.core.pipeline import LazyTraceback, MapperConfig
from repro_torch.core.streaming import FetchStallError
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops
from repro_torch.obs import registry as treg

FIELDS = ("position", "distance", "distance2", "mapped", "strand", "ops",
          "op_count", "n_candidates", "linear_dist", "failed")
COUNTERS = ("repro_retries_total", "repro_degradations_total",
            "repro_bisections_total", "repro_quarantined_reads_total",
            "repro_failed_blocks_total")


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


def policy(mod, **kw):
    return mod.RetryPolicy(**{**dict(max_attempts=2, backoff_s=0.0,
                                     bisect_min=4, degrade_after=1), **kw})


def assert_same_result(got, want, what=""):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), (what, f)
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")


# ------------------------------------------------------ policy objects

@pytest.mark.parametrize("cls,kw", [
    ("RetryPolicy", dict(max_attempts=0)),
    ("RetryPolicy", dict(bisect_min=0)),
    ("RetryPolicy", dict(backoff_mult=0.5)),
    ("RetryPolicy", dict(degrade_after=0)),
    ("AdmissionConfig", dict(policy="drop")),
    ("AdmissionConfig", dict(max_pending_reads=0)),
    ("AdmissionConfig", dict(deadline_s=0.0)),
])
def test_policy_configs_refuse_as_the_reference(cls, kw):
    with pytest.raises(ValueError) as want:
        getattr(jres, cls)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(tres, cls)(**kw)
    assert str(got.value) == str(want.value)


def test_mapping_error_shape():
    e = tres.MappingError("execution", "boom", n_reads=8, attempts=2)
    assert not e.ok and dataclasses.asdict(e) == dataclasses.asdict(
        jres.MappingError("execution", "boom", n_reads=8, attempts=2))


# ------------------------------------------------------- fault injector

SPECS = ("bucket=0.5,record=0.25,seed=3",
         "bucket=0.125,error=0.5,stall=0.3,stall_s=0,seed=9,poison=5;9,"
         "engines=fused;cuda",
         "flush=1,seed=0")


@pytest.mark.parametrize("spec", SPECS)
def test_injector_fires_the_reference_sites_in_order(spec):
    """Same spec, same calls: the same faults, in the same order, on every
    site, with the RNG streams keyed on (seed, crc32(site))."""
    j = jres.FaultInjector.from_spec(spec.replace("cuda", "pallas"))
    t = tres.FaultInjector.from_spec(spec)
    assert (t.seed, t.rates, t.stall_s, t.poison_rows, t.armed) == \
        (j.seed, j.rates, j.stall_s, j.poison_rows, j.armed)
    sites = ("bucket", "fastq_record", "fetch_error", "fetch_stall", "flush")
    order = np.random.default_rng(1).integers(0, len(sites), 300)
    assert [t.fire(sites[i]) for i in order] == \
        [j.fire(sites[i]) for i in order]
    for lo, hi in ((0, 4), (4, 8), (8, 16), (0, 64)):
        outcome = []
        for inj, backend in ((j, "pallas"), (t, "cuda")):
            try:
                inj.check_block(lo, hi, engine="compacted", backend=backend)
                outcome.append(None)
            except RuntimeError as e:
                outcome.append(str(e).replace("pallas", "cuda"))
        assert outcome[0] == outcome[1]
    assert (t.fired, t.checked) == (j.fired, j.checked)


def test_injector_spec_errors():
    with pytest.raises(ValueError, match="key=value"):
        tres.FaultInjector.from_spec("bucket")
    assert not tres.FaultInjector.from_spec("seed=3").armed


# ------------------------------------------------------- degrade ladder

def test_degrade_ladder_rungs_and_moves():
    """The card's ladder moves as the reference's ladder on ``jnp``: the
    engine steps down, the backend never does."""
    cfg = MapperConfig(engine="fused", wf_backend="cuda")
    t = tres.DegradeLadder(cfg, degrade_after=2)
    j = jres.DegradeLadder(JConfig(engine="fused", wf_backend="jnp"),
                           degrade_after=2)
    assert [(c.engine, c.wf_backend) for c in t.rungs] == [
        ("fused", "cuda"), ("compacted", "cuda")]
    moves = "ffoffoffff"
    for m in moves:
        if m == "f":
            assert t.fail() == j.fail()
        else:
            t.ok(), j.ok()
        assert (t.level, t.steps, t.degraded) == (j.level, j.steps,
                                                  j.degraded)
    assert t.describe() == j.describe().replace("jnp", "cuda")
    assert [c.engine for c in tres.DegradeLadder(
        MapperConfig(wf_backend="torch")).rungs] == ["compacted"]


@pytest.mark.parametrize("engine", ["fused", "compacted", "padded"])
def test_card_ladder_never_reaches_the_plain_versions(engine):
    """On a ``cuda`` config no rung names the ``torch`` backend: a block
    that fails on the last rung is quarantined, not mapped by the plain
    versions on the card."""
    rungs = tres.DegradeLadder(MapperConfig(engine=engine,
                                            wf_backend="cuda"),
                               degrade_after=1).rungs
    assert [c.wf_backend for c in rungs] == ["cuda"] * len(rungs)
    assert rungs[-1].engine == ("compacted" if engine == "fused"
                                else engine)


# -------------------------------------------- ResilientMapper vs reference

# (port engine/backend, reference backend, injector spec): the reference
# maps on jnp where the port maps on torch or cuda (on the CPU both are
# the plain versions, and neither ladder steps its backend down); a spec's
# "cuda" names the reference's backend.  With the backend marked failing
# every row is quarantined after one step down.
SCENARIOS = [
    ("compacted", "torch", "jnp", "poison=5;40,seed=1"),
    ("compacted", "cuda", "jnp", "bucket=0.3,seed=3"),
    ("fused", "torch", "jnp", "engines=fused,poison=17,bucket=0.2,seed=4"),
    ("fused", "cuda", "jnp", "engines=fused;cuda,poison=63,seed=5"),
]


def resilient_pair(world, engine, tback, jback, spec, **cfg):
    jidx, tidx, _ = world
    jinj = jres.FaultInjector.from_spec(spec.replace("cuda", jback))
    tinj = tres.FaultInjector.from_spec(spec)
    jm = JMapper(jidx, JConfig.from_index(jidx, engine=engine,
                                          wf_backend=jback,
                                          both_strands=True, **cfg))
    tm = Mapper(tidx, MapperConfig.from_index(tidx, engine=engine,
                                              wf_backend=tback,
                                              both_strands=True, **cfg),
                device="cpu")
    return (jres.ResilientMapper(jm, policy(jres), injector=jinj),
            tres.ResilientMapper(tm, policy(tres), injector=tinj))


@pytest.mark.parametrize("engine,tback,jback,spec", SCENARIOS)
def test_resilient_map_matches_reference(world, engine, tback, jback, spec):
    reads = world[2]
    jr = jreg.enable_metrics(jreg.MetricsRegistry())
    tr = treg.enable_metrics(treg.MetricsRegistry())
    jrm, trm = resilient_pair(world, engine, tback, jback, spec)
    for batch in (reads, reads[:24]):       # the ladder is sticky between
        want, wmask, wc = jrm.map(batch)
        got, gmask, gc = trm.map(batch)
        np.testing.assert_array_equal(gmask, wmask)
        assert gc == wc
        if "cuda" in spec:                  # every rung marked failing
            assert got is want is None and gmask.all()
        else:
            assert_same_result(got, want, spec)
            assert (got.stats.retries, got.stats.failed_reads) == \
                (want.stats.retries, want.stats.failed_reads)
        assert trm.ladder.level == jrm.ladder.level
        assert trm.cfg.engine == jrm.cfg.engine
    assert trm.counters == jrm.counters
    assert {c: tr.counter(c).value for c in COUNTERS} == \
        {c: jr.counter(c).value for c in COUNTERS}
    if "engines" in spec:
        assert trm.ladder.level == len(trm.ladder.rungs) - 1 > 0


@pytest.mark.parametrize("spec", ["engines=fused,poison=17,bucket=0.2,"
                                  "seed=4", "poison=5;40,seed=1"])
def test_resilient_mesh_matches_reference(world, spec):
    """A ``ResilientMapper`` over a one-shard mesh session: poisoned rows
    bisected and quarantined, a failing fused engine stepped down to the
    compacted rung on the same mesh — the reference's masks, counters,
    ladder and results."""
    jidx, tidx, reads = world
    kw = dict(engine="fused", both_strands=True)
    jm = JMapper(jidx, JConfig.from_index(jidx, **kw), topology="mesh",
                 n_shards=1)
    tm = Mapper(tidx, MapperConfig.from_index(tidx, **kw), topology="mesh",
                device="cpu")
    jrm = jres.ResilientMapper(jm, policy(jres),
                               injector=jres.FaultInjector.from_spec(spec))
    trm = tres.ResilientMapper(tm, policy(tres),
                               injector=tres.FaultInjector.from_spec(spec))
    for batch in (reads, reads[:24]):
        want, wmask, wc = jrm.map(batch)
        got, gmask, gc = trm.map(batch)
        np.testing.assert_array_equal(gmask, wmask)
        assert gc == wc
        assert_same_result(got, want, spec)
        assert (got.stats.dropped_send, got.stats.dropped_affine) == \
            (want.stats.dropped_send, want.stats.dropped_affine)
        assert trm.ladder.level == jrm.ladder.level
    assert trm.counters == jrm.counters
    rung = trm._mapper_at(trm.ladder.level)
    assert rung.topology == "mesh" and rung.mesh is tm.mesh
    if "engines" in spec:
        assert trm.cfg.engine == "compacted" and rung is not tm


def test_resilient_map_pairs_and_lazy_traceback(world):
    """``map_pairs`` splits the quarantine mask per mate; a lazy result
    stitched from bisected blocks (``LazyTraceback.concat``) materializes
    the reference's ops."""
    reads = world[2]
    jrm, trm = resilient_pair(world, "compacted", "torch", "jnp",
                              "poison=3;50,seed=2", cigar_mode="lazy")
    w1, w2, wc = jrm.map_pairs(reads[:32], reads[32:])
    g1, g2, gc = trm.map_pairs(reads[:32], reads[32:])
    assert gc == wc and wc["failed_reads"] == 8
    for g, w in ((g1, w1), (g2, w2)):
        assert isinstance(object.__getattribute__(g, "lazy_tb"),
                          LazyTraceback)
        assert_same_result(g, w)
    with pytest.raises(ValueError, match="pairwise"):
        trm.map_pairs(reads[:3], reads[:4])


def test_lazy_traceback_concat_matches_reference(world):
    jidx, tidx, reads = world
    want = JMapper(jidx, JConfig.from_index(jidx, cigar_mode="lazy")).map(
        reads)
    got = Mapper(tidx, MapperConfig.from_index(tidx, cigar_mode="lazy"),
                 device="cpu").map(reads)
    cuts = (0, 5, 6, 30, 64)
    parts = [(object.__getattribute__(r, "lazy_tb"))
             for r in (got, want)]
    jl, tl = (type(p).concat([p[a:b] for a, b in zip(cuts, cuts[1:])])
              for p in reversed(parts))
    assert len(tl) == len(jl) == len(reads)
    for a, b in zip(tl.materialize(), jl.materialize()):
        np.testing.assert_array_equal(a, b)
    assert LazyTraceback.concat([parts[0]]) is parts[0]


# ------------------------------------------------ the port's own rules

@pytest.mark.parametrize("err", [ops.KernelLaunchError,
                                 kbuild.KernelBuildError])
def test_kernel_errors_are_not_contained(world, monkeypatch, err):
    """A kernel's own error leaves ``map_segments`` at once: no retry, no
    bisection, no step down the ladder, nothing quarantined — and a
    service's flush raises it too instead of resolving the requests."""
    _, tidx, reads = world
    m = Mapper(tidx, MapperConfig.from_index(tidx, engine="fused"),
               device="cpu")
    calls = []

    def broken(plan, reads_):
        calls.append(len(reads_))
        raise err("linear_wf kernel launch failed: cudaError_t 719")
    monkeypatch.setattr(m, "run", broken)
    rm = tres.ResilientMapper(m, policy(tres, max_attempts=3))
    with pytest.raises(err, match="cudaError_t 719"):
        rm.map(reads)
    assert calls == [len(reads)]
    assert rm.counters == dict(retries=0, failed_reads=0, failed_blocks=0,
                               degraded_steps=0)
    assert rm.ladder.level == 0 and not rm._fallbacks
    svc = m.serve(retry=policy(tres))
    svc.submit(reads[:10])
    with pytest.raises(err):
        svc.flush()
    assert svc.totals["failed_requests"] == 0


def test_other_errors_are_contained(world, monkeypatch):
    """The same boundary still contains an ordinary error: retried,
    bisected, quarantined."""
    _, tidx, reads = world
    m = Mapper(tidx, MapperConfig.from_index(tidx), device="cpu")

    def broken(plan, reads_):
        raise RuntimeError("CUDA out of memory in the caller's code")
    monkeypatch.setattr(m, "run", broken)
    res, mask, c = tres.ResilientMapper(m, policy(tres)).map(reads[:8])
    assert res is None and mask.all() and c["failed_blocks"] == 2


@pytest.mark.parametrize("device,backend,built", [
    ("cuda", "cuda", True), ("cuda", "torch", False), ("cpu", "cuda", False)])
def test_card_session_builds_kernels_before_the_first_block(
        world, monkeypatch, device, backend, built):
    """A ``ResilientMapper`` over a card session with a ``cuda`` rung
    builds and loads every mapper kernel library when it is constructed,
    outside the containment boundary, and a failed build raises there.
    (A CPU session stands in with its device set to the card: no block
    runs.)"""
    _, tidx, _ = world
    m = Mapper(tidx, MapperConfig.from_index(tidx, wf_backend=backend),
               device="cpu")
    m.device = torch.device(device)
    loaded = []
    monkeypatch.setattr(kbuild, "entry", loaded.append)
    tres.ResilientMapper(m)
    assert loaded == (list(ops.MAPPER_ENTRIES) if built else [])

    def nvcc_fails(fn):
        raise kbuild.KernelBuildError("nvcc failed for linear_wf.cu")
    monkeypatch.setattr(kbuild, "entry", nvcc_fails)
    if built:
        with pytest.raises(kbuild.KernelBuildError, match="nvcc failed"):
            tres.ResilientMapper(m)
    else:
        tres.ResilientMapper(m)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_card_session_refuses_a_torch_without_accelerator_error(
        world, monkeypatch, device):
    """Without ``torch.AcceleratorError`` a CUDA error is a plain
    ``RuntimeError`` that the boundary would contain, so a card session's
    ``ResilientMapper`` (and the service built on it) is refused before
    any kernel is built; a CPU session is not."""
    _, tidx, _ = world
    m = Mapper(tidx, MapperConfig.from_index(tidx), device="cpu")
    m.device = torch.device(device)
    loaded = []
    monkeypatch.setattr(kbuild, "entry", loaded.append)
    monkeypatch.delattr(torch, "AcceleratorError", raising=False)
    if device == "cuda":
        for build in (lambda: tres.ResilientMapper(m), m.serve):
            with pytest.raises(RuntimeError, match="AcceleratorError"):
                build()
        assert loaded == []
    else:
        tres.ResilientMapper(m)
        m.serve()


def test_every_descent_is_loud(world, capsys):
    _, tidx, reads = world
    inj = tres.FaultInjector(fail_engines=["fused", "cuda"])
    m = Mapper(tidx, MapperConfig.from_index(tidx, engine="fused"),
               device="cpu", injector=inj)
    rm = tres.ResilientMapper(m, policy(tres), injector=inj)
    res, mask, c = rm.map(reads[:16])
    # the last rung fails too: quarantined, with no descent to the plain
    # versions
    assert res is None and mask.all() and c["degraded_steps"] == 1
    err = capsys.readouterr().err.splitlines()
    assert err == [
        "resilience: InjectedFault: injected engine fault: 'fused' is "
        "marked failing; engine ladder down to compacted/cuda (rung 1/1)"]
    # the fallback shares the session's device and placed index
    fb = rm._mapper_at(1)
    assert fb.device == m.device and fb._dev is m._dev
    assert fb.injector is inj and fb.cfg.wf_backend == "cuda"


def test_watchdog_raises_and_the_session_recovers(world):
    """A stalled fetch trips the watchdog within a few seconds of the
    dispatch (one chunk, so the dispatch is short), without joining the
    thread that sleeps for 30 s; a retry on the same session is clean.
    An alarm fails the test instead of hanging the suite."""
    _, tidx, reads = world

    class StallOnce(tres.FaultInjector):
        def __init__(self):
            super().__init__(stall_s=30.0, rates={"fetch_stall": 1.0})
            self.shots = 1

        def fire(self, site):
            if site == "fetch_stall" and self.shots > 0:
                self.shots -= 1
                return True
            return False

    def hung(signum, frame):
        raise AssertionError("the watchdog did not return in 20 s")
    old = signal.signal(signal.SIGALRM, hung)
    signal.alarm(20)
    try:
        m = Mapper(tidx, MapperConfig.from_index(tidx, chunk_reads=16),
                   device="cpu", injector=StallOnce(), watchdog_s=0.5)
        t0 = time.perf_counter()
        with pytest.raises(FetchStallError, match="watchdog"):
            m.map(reads[:16])
        assert time.perf_counter() - t0 < 0.5 + 5.0
        again = m.map(reads)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    clean = Mapper(tidx, MapperConfig.from_index(tidx), device="cpu")
    assert_same_result(again, clean.map(reads))
    with pytest.raises(ValueError, match="watchdog_s"):
        Mapper(tidx, device="cpu", watchdog_s=0)
