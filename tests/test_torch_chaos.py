"""Chaos suite of the port (``-m chaos``), the twin of
``tests/test_chaos.py``: a seeded ``FaultInjector`` against the port's
serving stack on the CPU.  A fault takes down only the work that caused
it, every request id resolves exactly once, the healthy part of the
stream equals a fault-free run — and the port's service resolves every
request as the reference's does under the same spec."""
import numpy as np
import pytest

from repro.core import resilience as jres
from repro.core import serving as jsrv
from repro.core.index import build_index as jbuild
from repro.core.pipeline import MapperConfig as JConfig
from repro.data.genome import (make_reference, sample_reads, write_fasta,
                               write_fastq)
from repro_torch.core.index import GenomeIndex
from repro_torch.core.mapper import Mapper
from repro_torch.core.pipeline import MapperConfig
from repro_torch.core.resilience import (FaultInjector, FetchStallError,
                                         InjectedFault, MappingError,
                                         ResilientMapper, RetryPolicy)
from repro_torch.core.serving import BatcherConfig, MappingService
from repro_torch.io.sam import validate_sam
from repro_torch.launch import map_fastq

pytestmark = pytest.mark.chaos

FAST = dict(max_attempts=3, backoff_s=0.0, bisect_min=4, degrade_after=2)


@pytest.fixture(scope="module")
def world():
    ref = make_reference(8_000, seed=11, repeat_frac=0.03)
    jidx = jbuild(ref)
    idx = GenomeIndex.from_arrays(jidx.uniq_kmers, jidx.offsets,
                                  jidx.positions, jidx.segments,
                                  read_len=jidx.read_len, k=jidx.k,
                                  w=jidx.w, eth=jidx.eth)
    rs = sample_reads(ref, 96, seed=13)
    return jidx, idx, rs.reads


def cpu_mapper(idx, **kw):
    inj = kw.pop("injector", None)
    wd = kw.pop("watchdog_s", None)
    return Mapper(idx, MapperConfig(**kw), device="cpu", injector=inj,
                  watchdog_s=wd)


# ----------------------------------------------------- streaming engine

def test_fetch_stall_trips_watchdog(world):
    _, idx, reads = world
    inj = FaultInjector(rates={"fetch_stall": 1.0}, stall_s=5.0)
    mapper = cpu_mapper(idx, chunk_reads=32, injector=inj, watchdog_s=0.25)
    with pytest.raises(FetchStallError, match="watchdog"):
        mapper.map(reads)
    assert inj.fired["fetch_stall"] >= 1


def test_fetch_error_propagates_promptly(world):
    _, idx, reads = world
    inj = FaultInjector(rates={"fetch_error": 1.0})
    with pytest.raises(InjectedFault, match="fetch_error"):
        cpu_mapper(idx, chunk_reads=32, injector=inj).map(reads)
    assert inj.checked["fetch_error"] == 1   # raised before chunk 2


def test_stalled_run_contained_by_resilient_mapper(world):
    _, idx, reads = world

    # the stall outlasts the dispatch of every chunk, which the CPU runs
    # while it dispatches (the reference's is asynchronous)
    class StallOnce(FaultInjector):
        def __init__(self):
            super().__init__(stall_s=20.0, rates={"fetch_stall": 1.0})
            self._shots = 1

        def fire(self, site):
            if site == "fetch_stall" and self._shots > 0:
                self._shots -= 1
                return True
            return False

    mapper = cpu_mapper(idx, chunk_reads=32, injector=StallOnce(),
                        watchdog_s=0.25)
    res, mask, counters = ResilientMapper(mapper,
                                          RetryPolicy(**FAST)).map(reads)
    assert not mask.any() and counters["retries"] == 1
    np.testing.assert_array_equal(res.position,
                                  cpu_mapper(idx).map(reads).position)


# ----------------------------------------------------- degrade ladder

def test_fail_engines_forces_degrade_to_compacted(world):
    _, idx, reads = world
    inj = FaultInjector(fail_engines=["fused"])
    rm = ResilientMapper(cpu_mapper(idx, engine="fused", injector=inj),
                         RetryPolicy(**{**FAST, "degrade_after": 1}),
                         injector=inj)
    res, mask, counters = rm.map(reads)
    assert rm.ladder.degraded and rm.cfg.engine == "compacted"
    assert rm.cfg.wf_backend == "cuda" and counters["degraded_steps"] == 1
    assert not mask.any()
    base = cpu_mapper(idx).map(reads)
    for f in ("position", "distance", "ops"):
        np.testing.assert_array_equal(getattr(res, f), getattr(base, f))
    res2, mask2, c2 = rm.map(reads[:32])   # sticky: straight to rung 1
    assert not mask2.any() and c2["retries"] == 0


# ------------------------------------------------------- service soak

def test_service_soak_matches_reference(world):
    """Random request sizes over four flushes at a 30% bucket fault rate:
    exactly-once resolution, healthy rows equal a fault-free session, and
    every resolution and total equal the reference service's."""
    jidx, idx, reads = world
    spec = "bucket=0.3,seed=5"
    batcher = dict(bucket_min=8, bucket_max=32)
    want_svc = jsrv.MappingService(
        jidx, JConfig(), jsrv.BatcherConfig(**batcher),
        retry=jres.RetryPolicy(**FAST),
        injector=jres.FaultInjector.from_spec(spec))
    svc = MappingService(idx, MapperConfig(), BatcherConfig(**batcher),
                         retry=RetryPolicy(**FAST),
                         injector=FaultInjector.from_spec(spec),
                         device="cpu")
    clean = cpu_mapper(idx)
    rng = np.random.default_rng(0)
    for _ in range(4):
        reqs = []
        for _ in range(int(rng.integers(1, 4))):
            n = int(rng.integers(3, 33))
            lo = int(rng.integers(0, len(reads) - n))
            reqs.append(reads[lo: lo + n])
        rids = [svc.submit(r) for r in reqs]
        assert [want_svc.submit(r) for r in reqs] == rids
        got, want = svc.flush(), want_svc.flush()
        assert sorted(got) == sorted(want) == rids   # exactly once
        for rid, req in zip(rids, reqs):
            g, w = got[rid], want[rid]
            if isinstance(w, jres.MappingError):
                assert isinstance(g, MappingError)
                assert (g.error_type, g.n_reads) == (w.error_type,
                                                      w.n_reads)
                continue
            failed = g.failed if g.failed is not None \
                else np.zeros(len(req), bool)
            assert (w.failed is None) == (g.failed is None)
            np.testing.assert_array_equal(g.position, w.position)
            np.testing.assert_array_equal(
                g.position[~failed], clean.map(req).position[~failed])
            assert not g.mapped[failed].any()
        assert svc.flush() == {} and want_svc.flush() == {}
    assert svc.totals == want_svc.totals
    assert svc.injector.fired == want_svc.injector.fired
    assert svc.totals["retries"] >= 1


def test_paired_request_quarantine_splits_per_mate(world):
    _, idx, reads = world
    inj = FaultInjector(poison_rows=[2])
    svc = MappingService(idx, MapperConfig(), BatcherConfig(bucket_min=8,
                                                            bucket_max=32),
                         retry=RetryPolicy(**FAST), injector=inj,
                         device="cpu")
    rid = svc.submit_paired(reads[:8], reads[8:16])
    res1, res2 = svc.flush()[rid]
    assert res1.failed is not None and res1.failed.any()
    assert not res1.mapped[res1.failed].any()
    assert res2.failed is None or not res2.failed.any()
    np.testing.assert_array_equal(res2.position,
                                  cpu_mapper(idx).map(reads[8:16]).position)


# ------------------------------------------------------------ CLI e2e

def test_map_fastq_chaos_run_completes_and_validates(tmp_path, capsys):
    ref = make_reference(8_000, seed=21)
    rs = sample_reads(ref, 160, seed=22, both_strands=True)
    names = [f"r{i}" for i in range(160)]
    fa, fq = str(tmp_path / "ref.fa"), str(tmp_path / "reads.fq")
    out, rej = str(tmp_path / "out.sam"), str(tmp_path / "rej.fq")
    write_fasta(fa, [("chr1", ref)])
    write_fastq(fq, rs, names=names)
    assert map_fastq.main([fa, fq, "-o", out, "--chunk-reads", "64",
                           "--on-error", "permissive", "--rejects", rej,
                           "--device", "cpu", "--inject",
                           "record=0.02,bucket=0.125,seed=3,poison=7"]) == 0
    err = capsys.readouterr().err
    text = open(out).read()
    validate_sam(text)
    sam_names = [ln.split("\t")[0] for ln in text.splitlines()
                 if ln and not ln.startswith("@")]
    rejected = [ln[1:].split()[0] for ln in open(rej).read().splitlines()
                if ln.startswith("@")]
    # exactly the injected-corrupt records are quarantined to the rejects
    # file; every other read is in the SAM once (poisoned rows as
    # synthesized unmapped records)
    assert rejected and len(rejected) < 20
    assert sorted(sam_names + rejected) == sorted(names)
    assert "quarantined:" in err and "resilience:" in err
    unmapped = sum(int(ln.split("\t")[1]) & 4 != 0
                   for ln in text.splitlines()
                   if ln and not ln.startswith("@"))
    assert unmapped >= 16
