"""``repro_torch``'s paired-end slice against ``repro``'s: the simulator,
``Mapper.map_pairs``, ``core.pairing`` (insert tracker, MAPQ, contig
test, pair resolution with mate rescue) and the paired SAM emitter, on
the reference pairing tests' world (a 12,000-base reference, reads of
100).  The port runs on the CPU, where its kernel wrappers take their
plain versions; the golden paired SAM comes out byte for byte apart from
``@PG``."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import pairing as jpair
from repro.core import wf_backend as jwfb
from repro.core.index import build_index as jbuild
from repro.core.mapper import Mapper as JMapper
from repro.core.pipeline import MapperConfig as JConfig
from repro.core.pipeline import MappingResult as JResult
from repro.data import genome as jgen
from repro.io import fasta as jfasta
from repro.io import sam as jsam
from repro_torch.core import pairing as tpair
from repro_torch.core import wf_backend as twfb
from repro_torch.core.index import GenomeIndex, build_index
from repro_torch.core.mapper import Mapper
from repro_torch.core.pipeline import MapperConfig, MappingResult
from repro_torch.data import genome as tgen
from repro_torch.io import fasta as tfasta
from repro_torch.io import sam as tsam
from repro_torch.kernels import ops

GOLDEN = Path(__file__).parent / "golden" / "paired_small.sam"
READ_LEN = 100
RESULT_FIELDS = ("position", "distance", "distance2", "mapped", "strand",
                 "ops", "op_count", "linear_dist", "n_candidates", "failed")
PAIR_FIELDS = ("proper", "mapq1", "mapq2", "rescued1", "rescued2", "insert")


@pytest.fixture(scope="module")
def world():
    """The reference pairing tests' world, indexed by the reference; the
    port maps over the same index arrays (``GenomeIndex.from_arrays``)."""
    ref = tgen.make_reference(12_000, seed=40, repeat_frac=0.0)
    jidx = jbuild(ref, read_len=READ_LEN)
    tidx = GenomeIndex.from_arrays(jidx.uniq_kmers, jidx.offsets,
                                   jidx.positions, jidx.segments,
                                   read_len=jidx.read_len, k=jidx.k,
                                   w=jidx.w, eth=jidx.eth)
    jmapper = JMapper(jidx, JConfig.from_index(jidx, both_strands=True))
    return ref, jidx, tidx, jmapper


def _body(text):
    return [ln for ln in text.splitlines() if not ln.startswith("@PG")]


def _same_array(a, b, what):
    assert (a is None) == (b is None), what
    if b is not None:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)


def _same_resolution(got, want):
    for m in ("res1", "res2"):
        for f in RESULT_FIELDS:
            _same_array(getattr(getattr(got, m), f),
                        getattr(getattr(want, m), f), f"{m}.{f}")
    for f in PAIR_FIELDS:
        _same_array(getattr(got, f), getattr(want, f), f)
    assert got.stats == want.stats


def test_golden_paired_sam_byte_for_byte():
    """The reference test's golden world end to end on the port alone:
    its ``make_reference``, ``build_index``, ``Mapper``, ``sample_pairs``,
    ``resolve_pairs`` and ``emit_paired_alignments``."""
    ref = tgen.make_reference(12_000, seed=40, repeat_frac=0.0)
    idx = build_index(ref, read_len=READ_LEN, device="cpu")
    cfg = MapperConfig.from_index(idx, both_strands=True)
    ps = tgen.sample_pairs(ref, 16, read_len=READ_LEN, insert_mean=300,
                           insert_sd=30, seed=779, unmappable_frac=0.15)
    res1, res2 = Mapper(idx, cfg, device="cpu").map_pairs(ps.reads1,
                                                          ps.reads2)
    pr = tpair.resolve_pairs(res1, res2, cfg=cfg, ref=ref,
                             reads1=ps.reads1, reads2=ps.reads2,
                             device="cpu")
    contigs = [tfasta.Contig("chrT", len(ref), 0)]
    recs = list(tsam.emit_paired_alignments(
        pr, [f"p779_{i}" for i in range(16)], ps.reads1, ps.quals1,
        ps.reads2, ps.quals2, tfasta.ReferenceMap(contigs)))
    text = "\n".join(tsam.sam_header(contigs) + recs) + "\n"
    golden = GOLDEN.read_text()
    assert _body(text) == _body(golden)
    assert text.replace("repro_torch.launch", "repro.launch") == golden
    tsam.validate_sam(text, expect_reads=32, require_mapq=True)


@pytest.mark.parametrize("seed", [1, 52, 779])
@pytest.mark.parametrize("unmappable_frac", [0.0, 0.25])
def test_sample_pairs_matches_reference(seed, unmappable_frac):
    ref = tgen.make_reference(5_000, seed=seed, repeat_frac=0.0)
    kw = dict(read_len=80, insert_mean=250, insert_sd=25, seed=seed,
              unmappable_frac=unmappable_frac)
    got = tgen.sample_pairs(ref, 24, **kw)
    want = jgen.sample_pairs(ref, 24, **kw)
    for f in dataclasses.fields(jgen.PairedReadSet):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_write_fastq_pair_writes_the_reference_files(tmp_path):
    ps = tgen.sample_pairs(tgen.make_reference(3_000, seed=2), 5,
                           read_len=60, insert_mean=200, seed=3)
    for pkg, tag in ((tgen, "t"), (jgen, "j")):
        pkg.write_fastq_pair(str(tmp_path / f"{tag}1.fq"),
                             str(tmp_path / f"{tag}2.fq"), ps)
        pkg.write_fastq_pair(None, None, ps,
                             interleaved_path=str(tmp_path / f"{tag}i.fq"))
    for name in ("1.fq", "2.fq", "i.fq"):
        assert (tmp_path / f"t{name}").read_text() == \
            (tmp_path / f"j{name}").read_text()


def test_map_pairs_matches_reference(world):
    ref, jidx, tidx, jmapper = world
    ps = tgen.sample_pairs(ref, 12, read_len=READ_LEN, insert_mean=300,
                           insert_sd=30, seed=51, unmappable_frac=0.2)
    want = jmapper.map_pairs(ps.reads1, ps.reads2)
    mapper = Mapper(tidx, MapperConfig.from_index(tidx, both_strands=True),
                    device="cpu")
    got = mapper.map_pairs(ps.reads1, ps.reads2)
    for g, w in zip(got, want):
        for f in RESULT_FIELDS:
            _same_array(getattr(g, f), getattr(w, f), f)
        assert g.stats.reads == w.stats.reads == 24
    with pytest.raises(ValueError, match="pairwise"):
        mapper.map_pairs(ps.reads1, ps.reads2[:-1])


def _killed(world, seed, n_pairs=24, n_kill=5):
    """The reference's mate results for a seeded batch, as numpy arrays,
    with the R2 mates of the first ``n_kill`` pairs whose mates both
    mapped and the R1 mate of the last such pair unmapped (so that
    rescue runs both ways)."""
    ref, _, _, jmapper = world
    ps = tgen.sample_pairs(ref, n_pairs, read_len=READ_LEN, insert_mean=300,
                           insert_sd=30, seed=seed, unmappable_frac=0.1)
    res1, res2 = jmapper.map_pairs(ps.reads1, ps.reads2)
    both = np.flatnonzero(res1.mapped & res2.mapped)
    arrays = []
    for res, kill in ((res1, both[-1:]), (res2, both[:n_kill])):
        a = {f: (None if getattr(res, f) is None
                 else np.array(getattr(res, f)))
             for f in RESULT_FIELDS}
        a["mapped"][kill] = False
        a["position"][kill] = -1
        arrays.append(a)
    return ps, arrays


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_resolve_pairs_matches_reference(world, backend):
    """The same mate results (killed mates included) through both
    packages' ``resolve_pairs``, two batches through one tracker each:
    every ``PairResolution`` field and the stats agree, and mates were
    rescued on both sides of a pair."""
    ref = world[0]
    jcfg = JConfig(read_len=READ_LEN)
    tcfg = MapperConfig(read_len=READ_LEN, wf_backend=backend)
    jtr, ttr = jpair.InsertSizeTracker(), tpair.InsertSizeTracker()
    rescued = [0, 0]
    for seed in (52, 53):
        ps, (a1, a2) = _killed(world, seed)
        kw = dict(ref=ref, reads1=ps.reads1, reads2=ps.reads2)
        want = jpair.resolve_pairs(JResult(**a1), JResult(**a2), cfg=jcfg,
                                   tracker=jtr, **kw)
        got = tpair.resolve_pairs(MappingResult(**a1), MappingResult(**a2),
                                  cfg=tcfg, tracker=ttr, device="cpu", **kw)
        _same_resolution(got, want)
        rescued[0] += int(got.rescued1.sum())
        rescued[1] += int(got.rescued2.sum())
    assert rescued[0] >= 1 and rescued[1] >= 5
    assert ttr._samples == jtr._samples


def test_resolve_pairs_does_not_mutate_its_inputs(world):
    ps, (a1, a2) = _killed(world, 52)
    r1, r2 = MappingResult(**a1), MappingResult(**a2)
    before = [np.array(r.position) for r in (r1, r2)]
    pr = tpair.resolve_pairs(r1, r2, cfg=MapperConfig(read_len=READ_LEN),
                             ref=world[0], reads1=ps.reads1,
                             reads2=ps.reads2, device="cpu")
    assert pr.stats["n_rescued"] >= 5
    for r, b in zip((r1, r2), before):
        np.testing.assert_array_equal(r.position, b)


def test_rescue_sweeps_the_reference_rows(world, monkeypatch):
    """The rows the port's rescue hands ``wf_backend.affine_wf_dist``
    (gathered on the device) are the reference's (sliced from its
    sentinel-padded copy), in its order and bucket, with the reference at
    the edges of the genome too: an anchor near each end."""
    ref, _, _, _ = world
    seen = {}

    def keep(mod, key):
        fn = mod.affine_wf_dist

        def wrapped(s1, win, **kw):
            seen.setdefault(key, []).append((np.asarray(s1),
                                             np.asarray(win)))
            return fn(s1, win, **kw)
        monkeypatch.setattr(mod, "affine_wf_dist", wrapped)
    keep(jwfb, "ref")
    keep(twfb, "port")
    ps, (a1, a2) = _killed(world, 52)
    G = len(ref)
    for i, p, s in ((0, 40, 1), (1, G - READ_LEN - 20, 0)):
        a1["position"][i], a1["strand"][i], a1["mapped"][i] = p, s, True
        a2["mapped"][i] = False
    kw = dict(ref=ref, reads1=ps.reads1, reads2=ps.reads2)
    jpair.resolve_pairs(JResult(**a1), JResult(**a2),
                        cfg=JConfig(read_len=READ_LEN), **kw)
    tpair.resolve_pairs(MappingResult(**a1), MappingResult(**a2),
                        cfg=MapperConfig(read_len=READ_LEN), device="cpu",
                        **kw)
    assert len(seen["port"]) == len(seen["ref"]) == 2
    for (ts1, twin), (js1, jwin) in zip(seen["port"], seen["ref"]):
        np.testing.assert_array_equal(ts1, js1)
        np.testing.assert_array_equal(twin, jwin)
    assert (seen["port"][0][1] == 4).any()   # SENTINEL past an edge


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_rescue_route(world, monkeypatch, backend):
    """The rescue sweep goes through ``wf_backend.affine_wf_dist`` with the
    config's backend: ``"cuda"`` reaches the kernel wrapper
    ``ops.affine_wf_dist`` (its plain version here, on CPU tensors);
    ``"torch"`` never reaches ``ops``."""
    calls, reached = [], []
    fn, op = twfb.affine_wf_dist, ops.affine_wf_dist

    def count(s1, win, **kw):
        calls.append(kw["backend"])
        return fn(s1, win, **kw)

    def count_op(s1, win, **kw):
        reached.append(s1.shape[0])
        return op(s1, win, **kw)
    monkeypatch.setattr(twfb, "affine_wf_dist", count)
    monkeypatch.setattr(ops, "affine_wf_dist", count_op)
    ps, (a1, a2) = _killed(world, 52)
    pr = tpair.resolve_pairs(MappingResult(**a1), MappingResult(**a2),
                             cfg=MapperConfig(read_len=READ_LEN,
                                              wf_backend=backend),
                             ref=world[0], reads1=ps.reads1,
                             reads2=ps.reads2, device="cpu")
    assert pr.stats["n_rescued"] >= 5
    assert calls == [backend, backend]
    if backend == "cuda":
        assert len(reached) == 2 and all(r % 128 == 0 for r in reached)
    else:
        assert reached == []


def test_rescue_without_a_device_needs_a_gpu(world, monkeypatch):
    """Pair resolution without rescue is host work; the rescue sweep runs
    on the card unless a device is named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ps, (a1, a2) = _killed(world, 52)
    cfg = MapperConfig(read_len=READ_LEN)
    pr = tpair.resolve_pairs(MappingResult(**a1), MappingResult(**a2),
                             cfg=cfg)
    assert pr.stats["n_rescued"] == 0
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tpair.resolve_pairs(MappingResult(**a1), MappingResult(**a2),
                            cfg=cfg, ref=world[0], reads1=ps.reads1,
                            reads2=ps.reads2)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_compute_mapq_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n, sat = 200, 32
    d1 = rng.integers(0, sat + 1, n)
    d2 = np.minimum(d1 + rng.integers(0, sat, n), sat)
    mapped, proper, mate = (rng.random((3, n)) < 0.7)
    for dist2 in (d2, None):
        for kw in ({}, dict(proper=proper, mate_mapped=mate)):
            got = tpair.compute_mapq(d1, dist2, mapped, sat=sat, **kw)
            want = jpair.compute_mapq(d1, dist2, mapped, sat=sat, **kw)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_insert_size_tracker_matches_reference(seed):
    """Both trackers fed the same inserts, batch by batch, from before the
    first sample to past ``max_samples``."""
    rng = np.random.default_rng(seed)
    kw = dict(max_samples=int(rng.integers(40, 200)),
              min_samples=int(rng.integers(2, 40)))
    got, want = tpair.InsertSizeTracker(**kw), jpair.InsertSizeTracker(**kw)
    for _ in range(8):
        batch = rng.normal(rng.integers(150, 600), rng.integers(0, 60),
                           int(rng.integers(0, 40))).astype(int)
        got.update(batch)
        want.update(batch)
        assert got.window() == want.window()
        assert got.rescue_window() == want.rescue_window()
        assert got.median == want.median
        assert got.n_observed == want.n_observed


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_contig_matches_reference(seed):
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(10_000, int(rng.integers(1, 6)),
                                replace=False))
    starts[0] = 0
    p1, p2 = rng.integers(0, 11_000, (2, 300))
    np.testing.assert_array_equal(tpair._same_contig(p1, p2, starts),
                                  jpair._same_contig(p1, p2, starts))
    np.testing.assert_array_equal(tpair._fr_geometry(p1, p1 % 2, p2,
                                                     p2 % 2, 120),
                                  jpair._fr_geometry(p1, p1 % 2, p2,
                                                     p2 % 2, 120))


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 15), min_size=1, max_size=12))
def test_emit_paired_matches_reference_on_synthetic_states(states):
    """The reference's adversarial mate states (every combination of
    mapped and strand per mate, far-apart loci) through both packages'
    ``resolve_pairs`` and ``emit_paired_alignments``: the same records."""
    n = len(states)
    rng = np.random.default_rng(sum(states) + 7 * n)
    sat = 32
    m1 = np.array([bool(s & 1) for s in states])
    m2 = np.array([bool(s & 2) for s in states])
    s1 = np.array([int(bool(s & 4)) for s in states], np.int8)
    s2 = np.array([int(bool(s & 8)) for s in states], np.int8)

    def mk(mapped, strand):
        pos = np.where(mapped, rng.integers(0, 900, n), -1).astype(np.int64)
        return dict(position=pos,
                    distance=np.where(mapped, rng.integers(0, 6, n), sat),
                    distance2=np.full(n, sat, dtype=np.int64),
                    mapped=np.asarray(mapped, bool),
                    strand=np.asarray(strand, np.int8))
    a1, a2 = mk(m1, s1), mk(m2, s2)
    reads = np.zeros((n, 20), np.uint8)
    quals = np.full((n, 20), ord("I"), np.uint8)
    names = [f"s{i}" for i in range(n)]
    out = []
    for pair, sam, fasta, cfg, Res in (
            (tpair, tsam, tfasta, MapperConfig(read_len=20), MappingResult),
            (jpair, jsam, jfasta, JConfig(read_len=20), JResult)):
        pr = pair.resolve_pairs(Res(**a1), Res(**a2), cfg=cfg)
        rm = fasta.ReferenceMap([fasta.Contig("c", 1000, 0)])
        out.append(list(sam.emit_paired_alignments(pr, names, reads, quals,
                                                   reads, quals, rm)))
    assert out[0] == out[1] and len(out[0]) == 2 * n
