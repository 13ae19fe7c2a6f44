"""The port's seeding front end against the reference: ``hash32``, the
minimizers, ``seed_reads``, ``build_index``, compaction and the window
gather give the reference's values exactly (codes and hashes are int64
holding the reference's uint32 values)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compaction as jcomp
from repro.core import filtering as jfilt
from repro.core import minimizers as jmin
from repro.core.index import build_index as jbuild
from repro.core.seeding import SeedParams as JSeedParams
from repro.core.seeding import seed_reads as jseed
from repro.data.genome import make_reference, sample_reads
from repro_torch.core import compaction as tcomp
from repro_torch.core import encoding as tenc
from repro_torch.core import filtering as tfilt
from repro_torch.core import minimizers as tmin
from repro_torch.core.index import GenomeIndex, build_index as tbuild
from repro_torch.core.seeding import SeedParams, seed_reads as tseed
from repro_torch.data import genome as tgenome


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module")
def world():
    ref = make_reference(20_000, seed=0, repeat_frac=0.02)
    return ref, jbuild(ref), tbuild(ref, device="cpu")


def test_hash32_matches_reference():
    r = np.random.default_rng(0)
    x = np.concatenate([r.integers(0, 2 ** 32, 4096, dtype=np.uint64),
                        [0, 1, 2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    got = tmin.hash32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, _np(jmin.hash32(jnp.asarray(x))))


@pytest.mark.parametrize("words", ["12-mer codes", "random"])
def test_unhash32_inverts_hash32(words):
    """hash32 is a bijection on 32 bits: unhash32 recovers every 12-mer
    code and a million random 32-bit words, so the minimizer kernel can
    return a window's k-mer code from its smallest hash."""
    if words == "random":
        x = torch.from_numpy(np.random.default_rng(3).integers(
            0, 2 ** 32, 10 ** 6, dtype=np.int64))
    else:
        x = torch.arange(1 << 24, dtype=torch.int64)
    np.testing.assert_array_equal(tmin.unhash32(tmin.hash32(x)).numpy(),
                                  x.numpy())
    np.testing.assert_array_equal(tmin.hash32(tmin.unhash32(x)).numpy(),
                                  x.numpy())


@pytest.mark.parametrize("k,w,L", [(12, 30, 150), (8, 16, 80), (16, 5, 40)])
def test_minimizers_match_reference(k, w, L):
    """Sentinel bases (4) included: they spill into the neighbouring 2-bit
    field exactly as the reference's uint32 shift-or does."""
    seqs = np.random.default_rng(k + w).integers(0, 5, (6, L)).astype(
        np.uint8)
    want = jmin.minimizers(jnp.asarray(seqs), k=k, w=w)
    got = tmin.minimizers(torch.from_numpy(seqs), k=k, w=w)
    for g, w_, name in zip(got, want, ("hash", "kmer", "pos")):
        np.testing.assert_array_equal(g.numpy(), _np(w_), err_msg=name)
    np.testing.assert_array_equal(
        tenc.kmer_codes(torch.from_numpy(seqs), k).numpy(),
        _np(jmin.kmer_codes(jnp.asarray(seqs), k)))


@pytest.mark.parametrize("max_uniq", [4, 16, 24])
def test_unique_read_minimizers_match_reference(max_uniq):
    """The M smallest distinct codes after a stable sort, per read."""
    reads = np.random.default_rng(max_uniq).integers(0, 4, (12, 150)).astype(
        np.uint8)
    reads[3] = np.tile([0, 1, 2, 3], 38)[:150]   # few distinct minimizers
    got = tmin.unique_read_minimizers(torch.from_numpy(reads),
                                      max_uniq=max_uniq)
    for i in range(len(reads)):
        want = jmin.unique_read_minimizers(jnp.asarray(reads[i]),
                                           max_uniq=max_uniq)
        for g, w_, name in zip(got, want, ("kmers", "pos", "valid")):
            np.testing.assert_array_equal(g[i].numpy().astype(np.int64),
                                          _np(w_), err_msg=f"{i}:{name}")


def test_build_index_matches_reference(world):
    _, ji, ti = world
    for f in ("uniq_kmers", "offsets", "positions", "segments"):
        np.testing.assert_array_equal(getattr(ti, f), getattr(ji, f),
                                      err_msg=f)
    assert (ti.seg_len, ti.pad) == (ji.seg_len, ji.pad)
    via = GenomeIndex.from_arrays(ji.uniq_kmers, ji.offsets, ji.positions,
                                  ji.segments, read_len=ji.read_len, k=ji.k,
                                  w=ji.w, eth=ji.eth)
    for f in ("uniq_kmers", "offsets", "positions", "segments"):
        np.testing.assert_array_equal(getattr(via, f), getattr(ti, f))
        assert getattr(via, f).dtype == getattr(ti, f).dtype


def test_build_index_caps_and_tiles(monkeypatch):
    """A repeat-rich reference with a tight PL cap, scanned in tiles far
    smaller than the reference (tile seams must not duplicate or drop an
    occurrence)."""
    import repro_torch.core.index as tindex
    ref = make_reference(12_000, seed=4, repeat_frac=0.3, repeat_len=200)
    want = jbuild(ref, read_len=60, k=10, w=12, eth=4,
                  max_pls_per_minimizer=2)
    monkeypatch.setattr(tindex, "_SCAN_TILE", 777)
    monkeypatch.setattr(tindex, "_GATHER_ROWS", 100)
    got = tbuild(ref, read_len=60, k=10, w=12, eth=4,
                 max_pls_per_minimizer=2, device="cpu")
    for f in ("uniq_kmers", "offsets", "positions", "segments"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_build_index_scan_rows_match_reference(monkeypatch, backend):
    """The index build's scan cut into rows of ``_SCAN_ROW`` windows (37,
    which divides no tile of 777 windows, and a last tile shorter than a
    row) on both backends: the reference's index, field for field."""
    import repro_torch.core.index as tindex
    ref = make_reference(9_000, seed=6, repeat_frac=0.2, repeat_len=150)
    ref[4_000:4_050] = 4                     # a run of N
    want = jbuild(ref, read_len=60, k=10, w=12, eth=4)
    monkeypatch.setattr(tindex, "_SCAN_TILE", 777)
    monkeypatch.setattr(tindex, "_SCAN_ROW", 37)
    got = tbuild(ref, read_len=60, k=10, w=12, eth=4, device="cpu",
                 backend=backend)
    for f in ("uniq_kmers", "offsets", "positions", "segments"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


# the port's field dtypes: the reference narrows offsets and positions to
# int32
PORT_DTYPES = {"uniq_kmers": np.uint32, "offsets": np.int64,
               "positions": np.int64, "segments": np.uint8}
SMALL = dict(read_len=60, k=10, w=12, eth=4)
SMALL_SEG = 2 * (60 + 4) - 10


def _edge_ref(case):
    """(reference, build keywords, module overrides) of one edge case."""
    if case == "cap":
        ref = make_reference(6_000, seed=14, repeat_frac=0.5, repeat_len=120)
        return ref, dict(max_pls_per_minimizer=1), {}
    if case == "tile_edges":
        ref = make_reference(2_500, seed=15, repeat_frac=0.1,
                             repeat_len=100)
        return ref, {}, dict(_SCAN_TILE=1, _SCAN_ROW=1)
    if case == "one_segment":
        return make_reference(SMALL_SEG + 1, seed=16), {}, {}
    # "sentinel_ends": every segment reaches past an end of the reference
    ref = make_reference(SMALL_SEG - 20, seed=17)
    ref[30:34] = 4
    return ref, dict(max_pls_per_minimizer=3), dict(_GATHER_ROWS=3)


@pytest.mark.parametrize("case", ["cap", "tile_edges", "one_segment",
                                  "sentinel_ends"])
def test_build_index_edges_match_reference(monkeypatch, case):
    """The build on a CPU device at its edges: a cap of one position a
    minimizer on a repeat-rich reference; a tile and a row of one window
    each, so that every window's dedup crosses a tile seam; a reference
    barely longer than one segment; and one shorter than a segment, every
    row padded with sentinels at one end or both.  Every field is the
    reference's, in the port's dtypes."""
    import repro_torch.core.index as tindex
    ref, kw, patch = _edge_ref(case)
    want = jbuild(ref, **SMALL, **kw)
    for name, value in patch.items():
        monkeypatch.setattr(tindex, name, value)
    got = tbuild(ref, **SMALL, **kw, device="cpu")
    for f, dt in PORT_DTYPES.items():
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == dt, f
    assert got.segments.shape == (len(want.positions), SMALL_SEG)
    # no tensor of the index keeps a larger storage alive
    assert [t.untyped_storage().nbytes() for t in got.tensors] == [
        t.nbytes for t in got.tensors]
    if case == "cap":
        assert np.diff(got.offsets).max() == 1
        assert len(want.positions) < len(np.unique(
            np.asarray(jmin.minimizers(jnp.asarray(ref), k=10, w=12)[2])))
    if case == "sentinel_ends":
        lead = got.segments[:, 0] == tenc.SENTINEL
        tail = got.segments[:, -1] == tenc.SENTINEL
        assert (lead | tail).all() and (lead & tail).any()


@pytest.mark.parametrize("source", ["built", "from_arrays"])
def test_index_host_fields_equal_tensors(world, source):
    """The numpy fields are made from the index's tensors at first access
    and kept: the tensors' values in the port's dtypes; the footprint is
    counted from the tensors alone, as from the fields."""
    _, ji, ti = world
    idx = ti if source == "built" else GenomeIndex.from_arrays(
        ji.uniq_kmers, ji.offsets, ji.positions, ji.segments,
        read_len=ji.read_len, k=ji.k, w=ji.w, eth=ji.eth)
    tensors = dict(zip(PORT_DTYPES, idx.tensors))
    assert [t.dtype for t in idx.tensors] == [torch.int64, torch.int64,
                                              torch.int64, torch.uint8]
    for f, dt in PORT_DTYPES.items():
        host = getattr(idx, f)
        assert host.dtype == dt and getattr(idx, f) is host, f
        np.testing.assert_array_equal(host, tensors[f].numpy(), err_msg=f)
    n_occ = len(idx.positions)
    seg = n_occ * ((idx.seg_len + 3) // 4 + (idx.seg_len + 7) // 8)
    table = (idx.uniq_kmers.nbytes + idx.offsets.nbytes
             + idx.positions.nbytes)
    assert idx.storage_bytes() == {
        "hash_table_bytes": table, "materialized_segments_bytes": seg,
        "total_bytes": table + seg, "blowup": seg / table}


@pytest.mark.parametrize("engine", ["compacted", "fused"])
def test_mapper_takes_built_index_as_is(world, engine):
    """A ``Mapper`` on the build's device holds the built index's own
    tensors, with no copy and no ``index.upload`` span, and maps a seeded
    batch exactly as a ``Mapper`` given the same index from host arrays."""
    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pipeline import MapperConfig
    from repro_torch.obs import tracing as ttrace
    ref, _, ti = world
    reads = sample_reads(ref, 24, seed=19, both_strands=True).reads
    cfg = MapperConfig.from_index(ti, engine=engine, chunk_reads=16,
                                  both_strands=True, cigar_mode="eager")
    tr = ttrace.enable_tracing(tracer_=ttrace.Tracer())
    try:
        m = Mapper(ti, cfg, device="cpu")
    finally:
        ttrace.disable_tracing()
    assert all(a is b for a, b in zip(m._dev, ti.tensors))
    assert "index.upload" not in {e.name for e in tr.spans()}
    host = GenomeIndex.from_arrays(ti.uniq_kmers, ti.offsets, ti.positions,
                                   ti.segments, read_len=ti.read_len,
                                   k=ti.k, w=ti.w, eth=ti.eth)
    got, want = m.map(reads), Mapper(host, cfg, device="cpu").map(reads)
    for f in ("position", "distance", "distance2", "mapped", "strand",
              "ops", "op_count", "linear_dist", "n_candidates"):
        x, y = getattr(got, f), getattr(want, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_index_to_copies_only_where_needed(world, device):
    """``GenomeIndex.to`` keeps the tensors that live on the device
    already and copies the others, shapes and dtypes kept, geometry
    unchanged."""
    _, _, ti = world
    moved = ti.to(device)
    assert (moved.read_len, moved.k, moved.w, moved.eth) == (
        ti.read_len, ti.k, ti.w, ti.eth)
    for a, b in zip(moved.tensors, ti.tensors):
        assert a.device.type == device
        assert (a is b) == (device == "cpu")
        assert a.shape == b.shape and a.dtype == b.dtype


def test_build_index_spans():
    """With a tracer armed the build records ``index.build`` (its bases,
    occurrence rows and segment bytes) over ``index.scan``,
    ``index.sort`` and ``index.segments``."""
    from repro_torch.obs import tracing as ttrace
    ref = make_reference(3_000, seed=18)
    tr = ttrace.enable_tracing(tracer_=ttrace.Tracer())
    try:
        idx = tbuild(ref, **SMALL, device="cpu")
    finally:
        ttrace.disable_tracing()
    spans = {e.name: e for e in tr.spans()}
    assert sorted(spans) == ["index.build", "index.scan", "index.segments",
                             "index.sort"]
    top = spans["index.build"]
    assert top.parent is None and top.args == {
        "bases": 3_000, "occurrences": len(idx.positions),
        "segment_bytes": idx.segments.nbytes}
    for name in ("index.scan", "index.sort", "index.segments"):
        assert spans[name].parent == top.sid, name


def test_build_index_rejects_bad_geometry():
    with pytest.raises(ValueError, match="k=20"):
        tbuild(np.zeros(1000, np.uint8), k=20, device="cpu")
    with pytest.raises(ValueError):
        GenomeIndex.from_arrays(np.zeros(1), np.zeros(2), np.zeros(1),
                                np.zeros((1, 5)), read_len=150, k=12, w=30,
                                eth=6)


@pytest.mark.parametrize("max_minis,max_pls", [(16, 32), (4, 2)])
def test_seed_reads_matches_reference(world, max_minis, max_pls):
    ref, ji, ti = world
    rs = sample_reads(ref, 10, seed=3, both_strands=True)
    junk = np.random.default_rng(9).integers(0, 4, (3, 150)).astype(np.uint8)
    reads = np.concatenate([rs.reads, junk])
    want = jseed(jnp.asarray(ji.uniq_kmers), jnp.asarray(ji.offsets),
                 jnp.asarray(reads), JSeedParams(max_minis=max_minis,
                                                 max_pls=max_pls))
    got = tseed(torch.from_numpy(ti.uniq_kmers.astype(np.int64)),
                torch.from_numpy(ti.offsets), torch.from_numpy(reads),
                SeedParams(max_minis=max_minis, max_pls=max_pls))
    assert set(got) == set(want)
    for f in want:
        np.testing.assert_array_equal(np.asarray(got[f]).astype(np.int64),
                                      _np(want[f]), err_msg=f)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_seed_reads_backends_match_reference(world, backend):
    """``seed_reads`` on either minimizer backend (on the CPU ``"cuda"``
    reaches the kernel's wrapper, which runs the plain version there):
    the reference's seeds."""
    ref, ji, ti = world
    rs = sample_reads(ref, 12, seed=8, both_strands=True)
    reads = rs.reads.copy()
    reads[0, 40:60] = 4                      # N bases in a read
    want = jseed(jnp.asarray(ji.uniq_kmers), jnp.asarray(ji.offsets),
                 jnp.asarray(reads), JSeedParams())
    got = tseed(torch.from_numpy(ti.uniq_kmers.astype(np.int64)),
                torch.from_numpy(ti.offsets), torch.from_numpy(reads),
                SeedParams(), backend=backend)
    for f in want:
        np.testing.assert_array_equal(np.asarray(got[f]).astype(np.int64),
                                      _np(want[f]), err_msg=f)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_unique_read_minimizers_backends_match_reference(backend):
    reads = np.random.default_rng(21).integers(0, 4, (9, 150)).astype(
        np.uint8)
    reads[4] = np.tile([3, 1, 0, 2], 38)[:150]
    got = tmin.unique_read_minimizers(torch.from_numpy(reads), max_uniq=16,
                                      backend=backend)
    for i in range(len(reads)):
        want = jmin.unique_read_minimizers(jnp.asarray(reads[i]),
                                           max_uniq=16)
        for g, w_, name in zip(got, want, ("kmers", "pos", "valid")):
            np.testing.assert_array_equal(g[i].numpy().astype(np.int64),
                                          _np(w_), err_msg=f"{i}:{name}")


def test_genome_simulator_is_the_reference_one():
    ref = make_reference(5_000, seed=2)
    np.testing.assert_array_equal(tgenome.make_reference(5_000, seed=2), ref)
    a = sample_reads(ref, 20, seed=5, both_strands=True)
    b = tgenome.sample_reads(ref, 20, seed=5, both_strands=True)
    for f in ("reads", "true_pos", "n_errors", "strand", "quals"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


@pytest.mark.parametrize("seed", range(4))
def test_compaction_matches_reference(seed):
    r = np.random.default_rng(seed)
    n = int(r.integers(1, 300))
    valid = r.random(n) < r.random()
    cap = tcomp.bucket_capacity(int(valid.sum()), align=8, cap_max=n)
    assert cap == jcomp.bucket_capacity(int(valid.sum()), align=8, cap_max=n)
    for c in (cap, max(cap // 4, 1)):   # also a capacity that overflows
        js, jok = jcomp.compact_indices(jnp.asarray(valid), c)
        ts, tok = tcomp.compact_indices(torch.from_numpy(valid), c)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(ts.numpy()[tok.numpy()],
                                      np.asarray(js)[np.asarray(jok)])
        vals = np.arange(c, dtype=np.int32) + 100
        want = jcomp.scatter_to(n, js, jok, jnp.asarray(vals), jnp.int32(-1))
        got = tcomp.scatter_to(n, ts, tok, torch.from_numpy(vals), -1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_windows_and_collapse_match_reference(world):
    _, ji, ti = world
    r = np.random.default_rng(1)
    occ = r.integers(0, len(ji.positions), 50)
    mpos = r.integers(0, 139, 50)
    want = jfilt.gather_windows(jnp.asarray(ji.segments), jnp.asarray(occ),
                                jnp.asarray(mpos), read_len=150, k=12, eth=6)
    got = tfilt.gather_windows(torch.from_numpy(ti.segments),
                               torch.from_numpy(occ), torch.from_numpy(mpos),
                               read_len=150, k=12, eth=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lin = r.integers(0, 8, (5, 4, 6)).astype(np.int32)
    for g, w_ in zip(tfilt.collapse_candidates(torch.from_numpy(lin), 3),
                     jfilt.collapse_candidates(jnp.asarray(lin), 3)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_encoding_helpers_match_reference():
    from repro.core import encoding as jenc
    s = "ACGTNacgtRYK"
    np.testing.assert_array_equal(tenc.encode_str(s), jenc.encode_str(s))
    codes = np.array([[0, 1, 2, 3, 4, 2]], np.uint8)
    np.testing.assert_array_equal(tenc.revcomp(codes), jenc.revcomp(codes))
    assert tenc.decode_to_str(codes[0]) == jenc.decode_to_str(codes[0])
    from repro.core.affine_wf import OP_CHARS, OP_NONE
    from repro.core.index import SENTINEL
    assert (tenc.OP_CHARS, tenc.OP_NONE, tenc.SENTINEL) == (OP_CHARS,
                                                          OP_NONE, SENTINEL)
