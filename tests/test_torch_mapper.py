"""``repro_torch``'s ``Mapper`` end to end against ``repro``'s (jnp
backend) on a 20 kb genome: every ``MappingResult`` field and the
``MapperStats`` counts, over both engines, both strand modes, all three
``cigar_mode``s and chunk sizes of 1, odd and larger than the batch.
The port runs on the CPU here, where its kernel wrappers take their
plain versions."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.index import build_index as jbuild
from repro.core.mapper import Mapper as JMapper
from repro.core.mapper import _reduce_strands as j_reduce_strands
from repro.core.mapper import split_result as j_split_result
from repro.core.pipeline import MapperConfig as JConfig
from repro.data.genome import make_reference, sample_reads
from repro_torch.core import mapper as tmapper
from repro_torch.core.index import GenomeIndex
from repro_torch.core.mapper import Mapper, check_card_geometry
from repro_torch.kernels import ops as tops
from repro_torch.core.pipeline import MapperConfig
from repro_torch.io.cigar import cigars_from_result

FIELDS = ("position", "distance", "distance2", "mapped", "strand", "ops",
          "op_count", "n_candidates", "linear_dist")
STAT_FIELDS = ("reads", "candidates", "survivors", "affine_instances",
               "padded_affine_instances", "reverse_best")


def _indexes(ref, **geometry):
    jidx = jbuild(ref, **geometry)
    tidx = GenomeIndex.from_arrays(jidx.uniq_kmers, jidx.offsets,
                                   jidx.positions, jidx.segments,
                                   read_len=jidx.read_len, k=jidx.k,
                                   w=jidx.w, eth=jidx.eth)
    return jidx, tidx


@pytest.fixture(scope="module")
def world():
    ref = make_reference(20_000, seed=0, repeat_frac=0.02)
    jidx, tidx = _indexes(ref)
    rs = sample_reads(ref, 10, seed=3, both_strands=True)
    junk = np.random.default_rng(5).integers(0, 4, (3, 150)).astype(np.uint8)
    return jidx, tidx, rs, np.concatenate([rs.reads, junk])


def map_both(world, **cfg):
    jidx, tidx, _, reads = world
    want = JMapper(jidx, JConfig.from_index(jidx, **cfg)).map(reads)
    got = Mapper(tidx, MapperConfig.from_index(tidx, **cfg),
                 device="cpu").map(reads)
    return got, want


def assert_same(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
            continue
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in STAT_FIELDS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    for k in want.stats.keys():
        if k != "stage_times_s":
            assert got.stats[k] == want.stats[k], k
    assert set(got.stats.get("stage_times_s", {})) == \
        set(want.stats.get("stage_times_s", {}))


# (both_strands, cigar_mode, chunk_reads, stream): every cigar mode, both
# strand modes, chunks of 1, odd and larger than the batch, both schedules
CASES = [
    (True, "eager", None, True),
    (True, "lazy", 5, True),
    (False, "off", 1, True),
    (False, "eager", 64, False),
]


@pytest.mark.parametrize("both_strands,cigar_mode,chunk,stream", CASES)
def test_compacted_engine_matches_reference(world, both_strands, cigar_mode,
                                            chunk, stream):
    got, want = map_both(world, engine="compacted", both_strands=both_strands,
                         cigar_mode=cigar_mode, chunk_reads=chunk,
                         stream=stream)
    assert_same(got, want)


def test_mapping_is_accurate_and_cigars_decode(world):
    _, tidx, rs, reads = world
    res = Mapper(tidx, MapperConfig.from_index(tidx, both_strands=True),
                 device="cpu").map(reads)
    n = len(rs.reads)
    ok = (np.abs(res.position[:n] - rs.true_pos) <= 6) & \
        (res.strand[:n] == rs.strand)
    assert ok.all()
    assert not res.mapped[n:].any() and (res.position[n:] == -1).all()
    cig = cigars_from_result(res.ops, res.op_count)
    assert all(c != "*" for c in cig[:n]) and all(c == "*" for c in cig[n:])


def test_session_api(world):
    """Plan, plan-cache counters, map_async, map_pairs, serve, a
    one-shard mesh session against the reference's, and the refusals."""
    _, tidx, _, reads = world
    m = Mapper(tidx, MapperConfig.from_index(tidx, chunk_reads=4),
               device="cpu")
    plan = m.plan(len(reads))
    assert plan.chunk_sizes == (4, 4, 4, 1) and plan.n_chunks == 4
    assert plan.lin_cap_max == 4 * 16 * 32 and plan.aff_cap_max == 64
    a = m.run(plan, reads)
    with m:
        b = m.map_async(reads).result(timeout=120)
    assert (m.plan_cache_misses, m.plan_cache_hits) == (1, 1)
    assert b.stats.plan_cache_hits == 1
    np.testing.assert_array_equal(a.position, b.position)
    r1, r2 = m.map_pairs(reads, reads[::-1])   # one stacked batch
    assert m.plan_cache_hits == 2
    np.testing.assert_array_equal(r1.position, a.position)
    np.testing.assert_array_equal(r2.position, a.position[::-1])
    with pytest.raises(ValueError, match="pairwise"):
        m.map_pairs(reads, reads[:-1])
    svc = m.serve()                    # a MappingService on this session
    assert svc.mapper is m and svc.batcher.cfg.bucket_max == 1024
    padded = Mapper(tidx, MapperConfig.from_index(tidx, engine="padded",
                                                  both_strands=True),
                    device="cpu")
    pplan = padded.plan(len(reads))     # one unchunked batch of 2n rows
    assert pplan.chunk_sizes == (2 * len(reads),)
    assert pplan.key == ("single", "padded", len(reads))
    mesh = Mapper(tidx, topology="mesh", device="cpu")     # one shard
    want = JMapper(world[0], topology="mesh", n_shards=1).map(reads)
    got = mesh.map(reads)
    for f in ("position", "distance", "distance2", "mapped"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.stats.as_dict().keys() == want.stats.as_dict().keys()
    assert mesh.plan(len(reads)).key == \
        JMapper(world[0], topology="mesh", n_shards=1).plan(len(reads)).key
    with pytest.raises(NotImplementedError, match="from_arrays"):
        Mapper(world[0], device="cpu")     # the reference's own index
    with pytest.raises(ValueError, match="wf_backend"):
        MapperConfig(wf_backend="pallas")
    with pytest.raises(ValueError, match="lin_block_r"):
        MapperConfig(lin_block_r=96)


@pytest.mark.parametrize("both_strands", [True, False])
def test_mesh_map_pairs_matches_reference(world, both_strands):
    """``map_pairs`` on a one-shard mesh: one stacked batch (on both
    strands, one fwd-then-rc stack reduced on the host), split per mate,
    equal to the reference's mesh session field for field."""
    jidx, tidx, _, reads = world
    kw = dict(both_strands=both_strands)
    jm = JMapper(jidx, JConfig.from_index(jidx, **kw), topology="mesh",
                 n_shards=1)
    tm = Mapper(tidx, MapperConfig.from_index(tidx, **kw), topology="mesh",
                device="cpu")
    for got, want in zip(tm.map_pairs(reads, reads[::-1]),
                         jm.map_pairs(reads, reads[::-1])):
        for f in ("position", "distance", "distance2", "mapped", "strand",
                  "ops"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if b is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)
        assert got.stats.reverse_best == want.stats.reverse_best
        assert got.stats.reads == want.stats.reads
    assert (tm.plan_cache_hits, tm.plan_cache_misses) == \
        (jm.plan_cache_hits, jm.plan_cache_misses)


def test_profiled_stream_records_stage_offsets(world):
    _, tidx, _, reads = world
    res = Mapper(tidx, MapperConfig.from_index(tidx, profile=True,
                                               chunk_reads=8),
                 device="cpu").map(reads)
    assert set(res.stats["stage_times_s"]) == {"seed", "linear", "affine",
                                               "traceback", "d2h"}


def test_mapper_without_device_needs_a_gpu(world, monkeypatch):
    _, tidx, _, _ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Mapper(tidx)
    from repro_torch.core.index import build_index
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_index(np.zeros(1000, np.uint8))


def test_torch_backend_matches_default(world):
    _, tidx, _, reads = world
    cfgs = [MapperConfig.from_index(tidx, wf_backend=b, both_strands=True)
            for b in ("cuda", "torch")]
    a, b = (Mapper(tidx, c, device="cpu").map(reads) for c in cfgs)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_split_and_reduce_strands_match_reference(world):
    """The host-side result helpers on a stacked fwd-then-rc result."""
    jidx, tidx, rs, _ = world
    from repro_torch.core.encoding import revcomp
    reads = np.concatenate([rs.reads[:6], revcomp(rs.reads[:6])])
    want = JMapper(jidx).map(reads)
    got = Mapper(tidx, device="cpu").map(reads)
    n = 6
    for g, w in zip(tmapper.split_result(got, n),
                    j_split_result(want, n)):
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), f
            if b is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)
    rg = tmapper._reduce_strands(got, n)
    rw = j_reduce_strands(dataclasses.replace(want), n)
    for f in FIELDS:
        a, b = getattr(rg, f), getattr(rw, f)
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert rg.stats.reverse_best == rw.stats.reverse_best


def test_eth_past_the_kernels_maps_on_cpu_and_is_refused_on_the_card(world):
    """An eth past ``ops.SUPPORTED_ETH`` maps on the CPU (the plain
    versions take any band) equal to the reference; on the card it is
    refused when the ``Mapper`` is built, naming ``eth``, before the index
    is placed on the device (here there is none: placing it would raise
    otherwise)."""
    eth = tops.SUPPORTED_ETH[-1] + 1
    ref = make_reference(20_000, seed=0, repeat_frac=0.02)
    jidx, tidx = _indexes(ref, eth=eth)
    reads = world[3]
    want = JMapper(jidx, JConfig.from_index(jidx, both_strands=True)).map(
        reads)
    cfg = MapperConfig.from_index(tidx, both_strands=True)
    got = Mapper(tidx, cfg, device="cpu").map(reads)
    assert_same(got, want)
    with pytest.raises(ValueError, match=f"^eth={eth} "):
        Mapper(tidx, cfg, device="cuda")
    # the torch backend runs no kernel: it passes the check, and only
    # placing the index on the absent card fails
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        Mapper(tidx, dataclasses.replace(cfg, wf_backend="torch"),
               device="cuda")


@pytest.mark.parametrize("overrides,field", [
    (dict(), None),
    (dict(eth=13), "eth"),
    (dict(sat_affine=86), "sat"),
    (dict(eth=12, read_len=500), "read_len"),  # the fused traceback's bound
    (dict(eth=12, read_len=500, engine="padded"), None),  # runs no such kernel
    (dict(eth=12, read_len=500, cigar_mode="off"), None),
    (dict(eth=13, wf_backend="torch"), None),
])
def test_check_card_geometry(overrides, field):
    """What the session refuses on a CUDA device, and that it refuses
    nothing on the CPU."""
    cfg = MapperConfig(**overrides)
    check_card_geometry(cfg, torch.device("cpu"))
    if field is None:
        check_card_geometry(cfg, torch.device("cuda"))
    else:
        with pytest.raises(ValueError, match=f"^{field}="):
            check_card_geometry(cfg, torch.device("cuda"))
