"""The port's padded reference engine, ``oracle_map``, the ``map_reads``
shim and the filtering twins against ``repro``'s (jnp backend).  The
port runs on the CPU here, where its kernel wrappers take their plain
versions; equality is exact (integer arithmetic)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filtering as jfilt
from repro.core.mapper import Mapper as JMapper
from repro.core.pipeline import MapperConfig as JConfig
from repro.core.pipeline import oracle_map as j_oracle_map
from repro.data.genome import make_reference, sample_reads
from repro_torch.core import filtering as tfilt
from repro_torch.core.mapper import Mapper, MapperStats, accumulate_stats
from repro_torch.core.pipeline import MapperConfig, map_reads, oracle_map

from test_torch_mapper import FIELDS, world  # noqa: F401


def _padded_pair(world, **cfg):
    jidx, tidx, _, reads = world
    want = JMapper(jidx, JConfig.from_index(jidx, engine="padded",
                                            **cfg)).map(reads)
    got = Mapper(tidx, MapperConfig.from_index(tidx, engine="padded",
                                               **cfg),
                 device="cpu").map(reads)
    return got, want


@pytest.mark.parametrize("both_strands", [True, False])
def test_padded_engine_matches_reference(world, both_strands):
    """Every ``MappingResult`` field, junk reads included; ``stats`` is
    None on both, as the padded engine keeps no instance accounting."""
    got, want = _padded_pair(world, both_strands=both_strands)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.stats is None and want.stats is None
    assert (got.strand is None) == (not both_strands)
    # the padded engine is the oracle of the other two
    comp = Mapper(world[1], MapperConfig.from_index(
        world[1], both_strands=both_strands), device="cpu").map(world[3])
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(comp, f),
                                      err_msg=f)


def test_padded_plan_cache_and_torch_backend(world):
    _, tidx, _, reads = world
    m = Mapper(tidx, MapperConfig.from_index(tidx, engine="padded",
                                             chunk_reads=4),
               device="cpu")
    a = m.map(reads)
    b = m.map(reads[:5])
    c = m.map(reads)
    assert (m.plan_cache_misses, m.plan_cache_hits) == (2, 1)
    np.testing.assert_array_equal(b.position, a.position[:5])
    np.testing.assert_array_equal(c.ops, a.ops)
    t = Mapper(tidx, MapperConfig.from_index(tidx, engine="padded",
                                             wf_backend="torch"),
               device="cpu").map(reads)
    for f in FIELDS:
        if getattr(a, f) is not None:
            np.testing.assert_array_equal(getattr(t, f), getattr(a, f))


def test_oracle_map_matches_reference():
    ref = make_reference(2_000, seed=4, repeat_frac=0.0)
    rs = sample_reads(ref, 4, seed=6)
    want = j_oracle_map(ref, rs.reads)
    got = oracle_map(ref, rs.reads, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (np.abs(got[0] - rs.true_pos) <= 6).all()
    # chunked scans give the same answer
    for g, w in zip(oracle_map(ref, rs.reads, chunk=700, device="cpu"), got):
        np.testing.assert_array_equal(g, w)


def test_map_reads_shim_warns_and_matches(world):
    _, tidx, _, reads = world
    cfg = MapperConfig.from_index(tidx, both_strands=True)
    with pytest.warns(DeprecationWarning, match="Mapper"):
        res = map_reads(tidx, reads, cfg, device="cpu")
    want = Mapper(tidx, cfg, device="cpu").map(reads)
    np.testing.assert_array_equal(res.position, want.position)
    np.testing.assert_array_equal(res.ops, want.ops)


def _windows(seed, R=5, M=3, P=4, rl=30, eth=6):
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (R, rl)).astype(np.uint8)
    wins = rng.integers(0, 5, (R, M, P, rl + 2 * eth)).astype(np.uint8)
    wins[:, 0, 0, eth : eth + rl] = reads         # exact placements
    valid = rng.random((R, M, P)) < 0.7
    return reads, wins, valid


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_linear_wf_filter_matches_reference(backend):
    reads, wins, valid = _windows(1)
    want = jfilt.linear_wf_filter(jnp.array(reads), jnp.array(wins),
                                  jnp.array(valid), eth=6)
    got = tfilt.linear_wf_filter(torch.from_numpy(reads),
                                 torch.from_numpy(wins),
                                 torch.from_numpy(valid), eth=6,
                                 backend=backend)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_base_count_filter_matches_reference():
    reads, wins, valid = _windows(2)
    want = jfilt.base_count_filter(jnp.array(reads), jnp.array(wins),
                                   jnp.array(valid), threshold=6)
    got = tfilt.base_count_filter(torch.from_numpy(reads),
                                  torch.from_numpy(wins),
                                  torch.from_numpy(valid), threshold=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_accumulate_stats_and_index_storage(world):
    jidx, tidx, _, reads = world
    totals = dict(survivors=0, affine_instances=0)
    st = MapperStats(topology="single", engine="compacted", reads=3,
                     candidates=7, survivors=2, affine_instances=256,
                     padded_affine_instances=48)
    accumulate_stats(totals, st)
    accumulate_stats(totals, st, fields=("survivors",))
    accumulate_stats(totals, None)          # padded engine: a no-op
    assert totals == dict(survivors=4, affine_instances=256)
    stor = Mapper(tidx, device="cpu").index_storage()
    want = jidx.storage_bytes()
    assert stor["materialized_segments_bytes"] == \
        want["materialized_segments_bytes"]
    assert stor["total_bytes"] == (stor["hash_table_bytes"]
                                   + stor["materialized_segments_bytes"])
