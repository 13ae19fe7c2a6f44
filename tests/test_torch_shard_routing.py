"""Shard-routed mapping in the port (``repro_torch.index.residency``)
against the reference's on the CPU.

The contracts: a ``ShardedGenomeIndex`` through the port's ``Mapper``
gives every ``MappingResult`` field of the reference's routed session and
of the port's flat-index session, and the reference's
``stats["partitions"]``, on the compacted and fused engines, with the
whole index resident, under a budget that evicts while later chunks are
already routed, and with prefetch; ``DeviceResidency`` makes the
reference's decisions (residents, counters, bases) on its eviction and
compaction sequences, with the same arena contents once a snapshot
applies its writes; the refusals speak the reference's words;
``seed_reads_routed`` gives the reference's seeds on both backends."""
import threading
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro.core.index import build_index as ref_build_flat
from repro.core.mapper import Mapper as RefMapper
from repro.core.pipeline import MapperConfig as RefConfig
from repro.core.seeding import SeedParams as RefSeedParams
from repro.core.seeding import seed_reads_routed as ref_seed_routed
from repro.data.genome import make_reference, sample_reads, write_fasta
from repro.index import build_sharded_index as ref_build
from repro.index import open_index as ref_open
from repro.index import shard_flat_index as ref_shard
from repro.index.residency import DeviceResidency as RefResidency
from repro.index.sharded import Partition as RefPartition
from repro_torch.core.index import GenomeIndex
from repro_torch.core.mapper import Mapper, accumulate_partition_stats
from repro_torch.core.pipeline import MapperConfig
from repro_torch.core.seeding import SeedParams, seed_reads_routed
from repro_torch.index import open_index, shard_flat_index
from repro_torch.index.residency import (DeviceResidency,
                                         arena_position_dtype)
from repro_torch.index.sharded import Partition
from repro_torch.obs import tracing as ttrace

READ_LEN, K, W, ETH = 60, 10, 12, 4
GEOM = dict(read_len=READ_LEN, k=K, w=W, eth=ETH)
N_PARTS = 32          # single-read chunks touch a strict subset of them
N_READS = 12
FIELDS = ("position", "distance", "distance2", "mapped", "strand", "ops",
          "op_count", "linear_dist", "n_candidates")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 6 kb reference built to disk by the reference into 32 partitions
    (odd tiles), opened by both packages; its flat index in both packages;
    reads on both strands."""
    d = tmp_path_factory.mktemp("torch_routing")
    ref = make_reference(6000, seed=21, repeat_frac=0.02)
    write_fasta(d / "ref.fa", [("chr1", ref)])
    ref_build(d / "ref.fa", d / "idx", num_partitions=N_PARTS, tile_bp=1001,
              **GEOM)
    f = ref_build_flat(ref, **GEOM)
    flat = GenomeIndex.from_arrays(f.uniq_kmers, f.offsets, f.positions,
                                   f.segments, **GEOM)
    rs = sample_reads(ref, N_READS, read_len=READ_LEN, seed=5,
                      both_strands=True)
    return ref_open(d / "idx"), open_index(d / "idx"), (f, flat), rs.reads


@pytest.fixture(scope="module")
def flat_runs(world):
    """{engine: (reference, port)} flat-index results at chunk_reads=1,
    the port's held equal to the reference's on every field."""
    _, _, (ref_flat, flat), reads = world
    out = {}
    for engine in ("compacted", "fused"):
        kw = dict(chunk_reads=1, engine=engine)
        want = RefMapper(ref_flat, RefConfig.from_index(ref_flat, **kw)
                         ).map(reads)
        got = Mapper(flat, MapperConfig.from_index(flat, **kw),
                     device="cpu").map(reads)
        _same_results(want, got, "flat")
        out[engine] = want, got
    return out


def _same_results(a, b, what):
    for f in FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), (what, f)
        if va is not None:
            assert np.array_equal(va, vb), (what, f)


def _reads_differ(a, b):
    """Per read: does any result field differ?"""
    out = np.zeros(len(a.position), bool)
    for f in FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if va is not None:
            out |= (va != vb).reshape(len(out), -1).any(axis=1)
    return out


def _half_budget(idx):
    rows = sum(p.n_occurrences for p in idx.parts) // 2
    return rows * (idx.seg_len + 4)


@pytest.mark.parametrize("case", ["resident", "evicting", "prefetch"])
@pytest.mark.parametrize("engine", ["compacted", "fused"])
def test_routed_mapper_matches_reference_and_flat(world, flat_runs, engine,
                                                  case):
    """Every field and ``stats["partitions"]`` equal the reference's
    routed session's, and the flat session's on every read where the
    reference's own routed and flat sessions agree.  They disagree on a
    read with no seed at all: with ``filter_threshold`` (6) above ``eth``
    (4) its empty minimizer slots pass the filter and reach the affine
    stage on occurrence row 0, which is another occurrence in the arena
    than in the flat index (ROADMAP.md Queue 3)."""
    ref_idx, idx, _, reads = world
    budget = None if case == "resident" else _half_budget(idx)
    prefetch = case == "prefetch"
    kw = dict(chunk_reads=1, engine=engine)
    want = RefMapper(ref_idx, RefConfig.from_index(ref_idx, **kw),
                     memory_budget_bytes=budget,
                     prefetch=prefetch).map(reads)
    with Mapper(idx, MapperConfig.from_index(idx, **kw), device="cpu",
                memory_budget_bytes=budget, prefetch=prefetch) as m:
        got = m.map(reads)
    _same_results(want, got, "reference")
    want_flat, got_flat = flat_runs[engine]
    quirk = _reads_differ(want, want_flat)
    assert np.array_equal(_reads_differ(got, got_flat), quirk)
    assert quirk.sum() <= 1 and (got.n_candidates[quirk] == 0).all()
    part = got.stats["partitions"]
    assert part == want.stats["partitions"]
    assert part["chunks_routed"] == N_READS
    if case == "resident":
        assert part["partition_loads"] == len(part["resident_partitions"])
        assert part["partition_evictions"] == 0
    else:
        assert part["partition_evictions"] > 0
        assert part["partition_compactions"] > 0
    assert (part["prefetch_loads"] > 0) == prefetch


def test_routed_both_strands_stream_and_sync(world):
    """Both strands a chunk, on the streamed and the synchronous path
    (where prefetch stages nothing); a second run finds every partition
    resident."""
    ref_idx, idx, _, reads = world
    kw = dict(chunk_reads=4, both_strands=True)
    want = RefMapper(ref_idx, RefConfig.from_index(ref_idx, **kw)).map(reads)
    for stream in (True, False):
        cfg = MapperConfig.from_index(idx, stream=stream, **kw)
        with Mapper(idx, cfg, device="cpu", prefetch=True) as m:
            tr = ttrace.enable_tracing(tracer_=ttrace.Tracer())
            try:
                got = m.map(reads)
            finally:
                ttrace.disable_tracing()
            # each chunk's fetch wrote its rows of the call's own arrays
            placed = sum(s.args["placed"] for s in tr.spans()
                         if s.name == "d2h")
            assert placed == sum(getattr(got, f).nbytes for f in FIELDS
                                 if getattr(got, f) is not None)
            _same_results(want, got, f"stream={stream}")
            again = m.map(reads)
        _same_results(want, again, f"again stream={stream}")
        assert again.stats["partitions"]["partition_loads"] == 0
        totals = accumulate_partition_stats({}, got.stats)
        accumulate_partition_stats(totals, again.stats)
        assert totals["partitions"]["chunks_routed"] == 6
        assert totals["partitions"]["minis_routed_per_partition"] == [
            2 * v for v in got.stats["partitions"][
                "minis_routed_per_partition"]]


# -------------------------------------------------------------- residency

def _ref_arena(res):
    return (np.asarray(res.positions_dev).astype(np.int64),
            np.asarray(res.segments_dev))


def _port_arena(res):
    pos, seg = res.snapshot()
    if pos.dtype == torch.int32:
        pos = pos.to(torch.int64) & 0xFFFFFFFF
    return pos.numpy(), seg.numpy()


def _same_residency(want, got):
    assert got.resident == want.resident
    for f in ("loads", "evictions", "compactions", "h2d_bytes",
              "prefetch_loads", "prefetch_hits", "cap_rows", "row_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    assert got._alloc == want._alloc
    for a, b in zip(_ref_arena(want), _port_arena(got)):
        assert np.array_equal(a, b)


def test_residency_lru_eviction_and_contents():
    """The reference's LRU sequence (``tests/test_shard_routing.py``) on
    4 partitions of a flat index: the same residents, counters and arena
    after every ensure."""
    ref = make_reference(20_000, seed=21, repeat_frac=0.02)
    f = ref_build_flat(ref, **GEOM)
    flat = GenomeIndex.from_arrays(f.uniq_kmers, f.offsets, f.positions,
                                   f.segments, **GEOM)
    ref_sidx, sidx = ref_shard(f, 4), shard_flat_index(flat, 4)
    rows = [p.n_occurrences for p in sidx.parts]
    budget = (max(rows) * 2 + max(rows) // 2) * (sidx.seg_len + 4)
    want, got = RefResidency(ref_sidx, budget), DeviceResidency(
        sidx, budget, device="cpu")
    for p in (0, 1, 2, 3, 0):
        assert got.ensure([p]) == want.ensure([p])
        _same_residency(want, got)
    assert got.evictions >= 2 and 0 in got.resident
    need = got.resident[:1]
    assert got.ensure(need) == want.ensure(need)
    _same_residency(want, got)


def _synthetic(cls, sizes, seg_len):
    rng = np.random.default_rng(7)
    return [cls(kmers=np.arange(n, dtype=np.uint32),
                offsets=np.arange(n + 1, dtype=np.int32),
                positions=(1000 * (i + 1) + np.arange(n)).astype(np.int32),
                seg_len=seg_len,
                segments_raw=rng.integers(0, 4, (n, seg_len),
                                          dtype=np.uint8))
            for i, n in enumerate(sizes)]


def _pair(sizes, seg_len, cap_rows):
    idx = [types.SimpleNamespace(parts=_synthetic(cls, sizes, seg_len),
                                 seg_len=seg_len)
           for cls in (RefPartition, Partition)]
    budget = cap_rows * (seg_len + 4)
    return RefResidency(idx[0], budget), DeviceResidency(idx[1], budget,
                                                         device="cpu")


def test_compaction_relocates_pinned_and_bases_stay_authoritative():
    """The reference's compaction sequence: ensure([1, 3]) evicts 0 and
    2, compacts (moving partition 1 from row 20 to row 0, a move onto
    itself shifted by 20 rows) and returns the post-compaction bases."""
    want, got = _pair([20, 30, 30, 60], 8, 100)
    assert got.ensure([0, 1, 2]) == want.ensure([0, 1, 2]) == \
        {0: 0, 1: 20, 2: 50}
    _same_residency(want, got)
    assert got.ensure([1, 3]) == want.ensure([1, 3]) == {1: 0, 3: 30}
    assert got.evictions == 2 and got.compactions == 1
    _same_residency(want, got)


def test_compaction_moves_long_partitions_by_short_shifts(monkeypatch):
    """Moves far longer than their shift (a partition of 300 rows moved
    left by 10, through scratch pieces of 16 rows) keep every row."""
    from repro_torch.index import residency
    monkeypatch.setattr(residency, "_SCRATCH_ROWS", 16)
    want, got = _pair([10, 300, 40, 55], 6, 360)
    for parts in ([0, 1], [2], [1, 3]):
        assert got.ensure(parts) == want.ensure(parts)
        _same_residency(want, got)
    assert got.compactions == want.compactions == 1


def test_writes_wait_for_the_ticket_that_needs_them():
    """An ensure for a later chunk (ticket 1) evicts a partition the
    earlier chunk (ticket 0) routed against; the earlier chunk's snapshot
    still holds that partition's rows, the later one's holds its
    replacement."""
    _, got = _pair([40, 40, 40], 4, 80)
    part0 = got.index.parts[0]
    assert got.ensure([0, 1]) == {0: 0, 1: 40}
    t0 = got.ticket()
    assert got.ensure([2]) == {2: 0}         # evicts 0, loads 2 at its rows
    t1 = got.ticket()
    pos, seg = got.snapshot(upto=t0)
    assert np.array_equal(seg[:40].numpy(), part0.segments_raw)
    assert np.array_equal(pos[:40].numpy(), part0.positions)
    pos, seg = got.snapshot(upto=t1)
    assert np.array_equal(seg[:40].numpy(), got.index.parts[2].segments_raw)


def test_prefetch_racing_ensure_loads_exactly_once():
    seg_len = 8
    parts = _synthetic(Partition, [10, 10, 10, 10], seg_len)
    res = DeviceResidency(types.SimpleNamespace(parts=parts,
                                                seg_len=seg_len),
                          device="cpu")
    barrier = threading.Barrier(8)

    def hammer(i):
        barrier.wait(timeout=30)
        return (res.prefetch if i % 2 else res.ensure)([i % 4])

    with ThreadPoolExecutor(max_workers=8) as ex:
        outs = list(ex.map(hammer, range(8), timeout=60))
    assert res.loads == 4 and len(res._alloc) == 4
    pos, _ = res.snapshot()
    for out in outs:
        for p, base in out.items():
            assert res._alloc[p][0] == base
            assert np.array_equal(pos[base:base + 10].numpy(),
                                  parts[p].positions)


def test_prefetch_is_best_effort_where_ensure_raises():
    """``prefetch`` of more than the budget holds returns None where
    ``ensure`` raises; otherwise it stages as ``ensure(prefetch=True)``,
    and a later ``ensure`` counts the hit: the reference's bases,
    residents, counters and arena after every call."""
    want, got = _pair([60, 30, 20], 8, 70)
    for res in (want, got):
        assert res.prefetch([0, 1]) is None
        with pytest.raises(ValueError):
            res.ensure([0, 1])
    _same_residency(want, got)
    assert got.prefetch([1, 2]) == want.prefetch([1, 2])
    _same_residency(want, got)
    assert got.ensure([2]) == want.ensure([2])
    assert got.prefetch_hits == 1 and got.prefetch_loads >= 2
    _same_residency(want, got)


@pytest.mark.parametrize("ref_len,dtype,row_pos_bytes", [
    (1000, torch.int32, 4), (2**31 + 5, torch.int32, 4),
    (2**32 - 1, torch.int32, 4), (2**32, torch.int64, 8)])
def test_arena_row_bytes(ref_len, dtype, row_pos_bytes):
    """4 position bytes a row below 2^32 - 1 (the reference's int32, then
    uint32 rows, so the same budget gives the same arena), 8 past it,
    where the reference needs jax's x64 (ROADMAP.md Queue 3)."""
    from repro.core.index import device_position_dtype
    assert arena_position_dtype(ref_len) == dtype
    idx = types.SimpleNamespace(parts=_synthetic(Partition, [10], 6),
                                seg_len=6, ref_len=ref_len)
    got = DeviceResidency(idx, 20 * (6 + row_pos_bytes), device="cpu")
    assert got.row_bytes == 6 + row_pos_bytes and got.cap_rows == 20
    assert got.positions_dev.dtype == dtype
    if ref_len < 2**32:
        assert device_position_dtype(ref_len).itemsize == row_pos_bytes


# --------------------------------------------------------------- refusals

def test_refusals_in_the_reference_words(world):
    ref_idx, idx, flat, _ = world
    biggest = max(p.n_occurrences for p in idx.parts)
    cases = [
        (dict(cfg=dict(engine="padded")), 'engine="padded"'),
        (dict(cfg=dict(cigar_mode="lazy")), 'cigar_mode="lazy"'),
        (dict(budget=(biggest - 1) * (idx.seg_len + 4)),
         "largest partition"),
        (dict(budget=16), "memory_budget_bytes"),
        (dict(flat=True, budget=1 << 20), "memory_budget_bytes only"),
        (dict(flat=True, prefetch=True), "prefetch=True only"),
    ]
    for kw, msg in cases:
        for MapperCls, Cfg, sidx, extra in (
                (RefMapper, RefConfig, ref_idx, {}),
                (Mapper, MapperConfig, idx, dict(device="cpu"))):
            src = sidx
            if kw.get("flat"):
                src = flat[1] if MapperCls is Mapper else flat[0]
            with pytest.raises(ValueError, match=msg):
                MapperCls(src, Cfg.from_index(src, **kw.get("cfg", {})),
                          memory_budget_bytes=kw.get("budget"),
                          prefetch=kw.get("prefetch", False), **extra)


@pytest.mark.parametrize("kw,msg", [
    (dict(budget=1 << 20), "the mesh topology places one whole partition"),
    (dict(prefetch=True), "prefetch=True only applies"),
    (dict(), "has 32 partitions but the mesh has 1 devices"),
])
def test_mesh_refusals_in_the_reference_words(world, kw, msg):
    """A partitioned index on the mesh: no arena budget, no prefetch, and
    one partition per shard — refused alike by both packages."""
    ref_idx, idx, _, _ = world
    for MapperCls, sidx, extra in ((RefMapper, ref_idx, {}),
                                   (Mapper, idx, dict(device="cpu"))):
        with pytest.raises(ValueError, match=msg):
            MapperCls(sidx, topology="mesh", n_shards=1,
                      memory_budget_bytes=kw.get("budget"),
                      prefetch=kw.get("prefetch", False), **extra)


def test_mesh_maps_the_partitions_as_the_routed_session(world, flat_runs):
    """The 32 partitions on a 32-shard mesh (partition i on shard i)
    against the flat index's single-topology result: the same positions,
    distances and strands where the mesh dropped nothing, and the
    per-partition survivor counts summing to the stage-B survivors."""
    _, idx, _, reads = world
    got = Mapper(idx, MapperConfig.from_index(idx, both_strands=True),
                 topology="mesh", n_shards=N_PARTS, device="cpu").map(reads)
    want = Mapper(idx, MapperConfig.from_index(idx, both_strands=True,
                                               chunk_reads=4),
                  device="cpu").map(reads)
    assert got.stats.dropped_send == got.stats.dropped_affine == 0
    for f in ("position", "distance", "strand", "mapped"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    part = got.stats["partitions"]
    assert part["num_partitions"] == N_PARTS
    assert part["occurrences_per_partition"] == \
        [p.n_occurrences for p in idx.parts]
    assert sum(part["survivors_per_partition"]) == got.stats.survivors


def test_evict_error_accounts_for_freed_unpinned_rows():
    want, got = _pair([60, 30], 8, 70)
    for res in (want, got):
        with pytest.raises(ValueError) as ei:
            res.ensure([0, 1])
        msg = str(ei.value)
        assert "unpinned resident is already evicted" in msg
        assert "90 occurrence" in msg and "60 rows" in msg


# ---------------------------------------------------------------- seeding

@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_seed_reads_routed_matches_reference(world, backend):
    ref_idx, idx, _, reads = world
    rng = np.random.default_rng(3)
    batch = np.concatenate([reads, rng.integers(0, 4, (3, READ_LEN),
                                                dtype=np.uint8)])
    batch[0, 10:14] = 4                      # a read holding SENTINEL
    bases = {p: 1000 * p + 7 for p in range(N_PARTS)}
    seen = []

    def ensure(parts):
        seen.append(list(parts))
        return {p: bases[p] for p in parts}

    want = ref_seed_routed(ref_idx, batch,
                           RefSeedParams(k=K, w=W, max_minis=8, max_pls=4),
                           ensure)
    got = seed_reads_routed(idx, batch, SeedParams(k=K, w=W, max_minis=8,
                                                   max_pls=4), ensure,
                            backend=backend, device="cpu")
    assert seen[0] == seen[1] and len(seen[0]) > 1
    for k in want[0]:
        a, b = np.asarray(want[0][k]), np.asarray(got[0][k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert np.array_equal(want[1], got[1])
    assert np.array_equal(want[2], got[2])


def test_origin_index_straddling_2_31_maps_as_reference(tmp_path):
    """An index at an origin straddling 2^31 (the reference's uint32
    arena rows, the port's int32 words read as unsigned): every field and
    the partition stats equal the reference's, positions past 2^31."""
    origin = 2**31 - 1500
    ref = make_reference(6000, seed=13, repeat_frac=0.02)
    write_fasta(tmp_path / "ref.fa", [("chrBig", ref)])
    ref_build(tmp_path / "ref.fa", tmp_path / "idx", num_partitions=4,
              tile_bp=1023, origin=origin, **GEOM)
    ref_idx, idx = ref_open(tmp_path / "idx"), open_index(tmp_path / "idx")
    rs = sample_reads(ref, 16, read_len=READ_LEN, seed=5, both_strands=True)
    kw = dict(chunk_reads=8, both_strands=True)
    want = RefMapper(ref_idx, RefConfig.from_index(ref_idx, **kw)).map(
        rs.reads)
    with Mapper(idx, MapperConfig.from_index(idx, **kw), device="cpu") as m:
        got = m.map(rs.reads)
        assert m.router.residency.positions_dev.dtype == torch.int32
    _same_results(want, got, "origin")
    assert got.stats["partitions"] == want.stats["partitions"]
    pos = got.position[got.mapped]
    assert (pos >= 2**31).any() and (pos < 2**31).any()
    want_pos = rs.true_pos.astype(np.int64) + origin
    assert (np.abs(pos - want_pos[got.mapped]) <= ETH).all()
