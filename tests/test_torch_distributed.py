"""``repro_torch.core.distributed`` and ``Mapper(topology="mesh")`` against
``repro.core.distributed`` and the reference's mesh, bit for bit on the
CPU: the sharded index arrays at S = 1, 2, 4 and 8, ``_bucket_by_dst``
with drops, ``_stage_b`` on the same received entries, and the mesh
session's ``position``, ``distance``, ``distance2``, ``strand``,
``mapped``, every ``stage_b_*`` and ``send_dropped*`` stat and the
plan-cache counters — both strands and one, default capacities,
``send_cap=2``, ``stage_b_survivor_frac=0.001`` with ``aff_block_r=8``, an
adaptive session whose survivor capacity moves, a k=16 world with a
poly-T read (with and without an all-T k-mer in the index), the
deprecated ``distributed_map_reads``, the service on the mesh, the
mesh-placed partitions of a ``ShardedGenomeIndex`` and the mesh rung of
a ``ResilientMapper``.

The reference at S > 1 needs S devices: it runs once, in a module-scoped
subprocess with ``XLA_FLAGS`` forcing 8 host devices (as
``tests/test_distributed.py`` does), and hands back an ``.npz``.  The
port's group form (one shard per rank) runs as 4 gloo ranks in a
subprocess and is held to its local form.
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core.pipeline import MapperConfig as JConfig
from repro.index import shard_flat_index as jshard_flat
from repro_torch.core import distributed as tdist
from repro_torch.core import resilience as tres
from repro_torch.core.index import GenomeIndex
from repro_torch.core.mapper import Mapper
from repro_torch.core.pipeline import MapperConfig
from repro_torch.core.serving import BatcherConfig, MappingService
from repro_torch.index import shard_flat_index
from repro_torch.launch.mesh import make_genomics_mesh

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
RESULT_FIELDS = ("position", "distance", "distance2", "mapped", "strand")
SHARD_FIELDS = ("uniq_kmers", "offsets", "positions", "segments")

# the worlds, built alike here and in the reference's subprocess
WORLD_SRC = r'''
import numpy as np
from repro.core.index import build_index
from repro.data.genome import make_reference, sample_reads


def make_world(name):
    """(reference, index, reads): "main" is a 20 kb genome with 60 reads
    on both strands and 5 junk reads (65: no shard count divides it);
    "k16" a 12 kb genome with a 200-base T run, k=16 (the all-T k-mer's
    code is the 0xFFFFFFFF padding value), 24 reads and a poly-T read;
    "k16_norun" the same without the run, so no all-T k-mer is indexed."""
    if name == "main":
        ref = make_reference(20_000, seed=0, repeat_frac=0.02)
        idx = build_index(ref)
        rs = sample_reads(ref, 60, seed=3, both_strands=True)
        junk = np.random.default_rng(5).integers(0, 4, (5, 150))
        return ref, idx, np.concatenate([rs.reads, junk.astype(np.uint8)])
    ref = make_reference(12_000, seed=4, repeat_frac=0.02)
    if name == "k16":
        ref[3000:3200] = 3
    idx = build_index(ref, k=16)
    rs = sample_reads(ref, 24, seed=6, both_strands=True)
    poly_t = np.full((1, 150), 3, np.uint8)
    return ref, idx, np.concatenate([rs.reads, poly_t])
'''

# mesh cases: name -> (world, n_shards, config overrides, Mapper keywords)
CASES = {
    "s1": ("main", 1, {}, {}),
    "s2": ("main", 2, {}, {}),
    "s4": ("main", 4, {}, {}),
    "s8": ("main", 8, {}, {}),
    "s4_one_strand": ("main", 4, {"both_strands": False}, {}),
    "s8_send_cap_2": ("main", 8, {}, {"send_cap": 2}),
    "s8_survivor_frac": ("main", 8, {"stage_b_survivor_frac": 0.001,
                                     "aff_block_r": 8}, {}),
    "s2_k16_t_run": ("k16", 2, {}, {}),
    "s4_k16_no_t_run": ("k16_norun", 4, {}, {}),
}
# the adaptive session's batches (slices of the main world's reads)
ADAPTIVE = ((0, 65), (0, 65), (0, 33), (0, 65), (10, 43))
STATS = ("stage_b_entries", "stage_b_survivors", "stage_b_affine_capacity",
         "stage_b_affine_instances", "stage_b_padded_affine_instances",
         "stage_b_affine_dropped", "send_dropped", "send_dropped_per_shard",
         "stage_b_survivors_per_shard", "padded_reads")
UNIFIED = ("reads", "candidates", "survivors", "affine_instances",
           "padded_affine_instances", "dropped_send", "dropped_affine",
           "reverse_best", "plan_cache_hits", "plan_cache_misses")

_REF_SCRIPT = WORLD_SRC + r'''
import json, sys, warnings
from repro.core import resilience as jres
from repro.core.distributed import distributed_map_reads, shard_index
from repro.core.mapper import Mapper
from repro.core.pipeline import MapperConfig
from repro.core.serving import BatcherConfig, MappingService
from repro.index import shard_flat_index
from repro.launch.mesh import make_genomics_mesh

spec = json.loads(sys.argv[1])
arrays, meta = {}, {}


def keep(name, res, **extra):
    for f in ("position", "distance", "distance2", "mapped", "strand"):
        v = getattr(res, f)
        if v is not None:
            arrays[f"{name}/{f}"] = np.asarray(v)
    st = res.stats
    meta[name] = dict(
        stats={k: np.asarray(st[k]).tolist() for k in spec["stats"]},
        unified={k: int(getattr(st, k)) for k in spec["unified"]},
        partitions=st.get("partitions"), **extra)


worlds = {}
def world(name):
    if name not in worlds:
        worlds[name] = make_world(name)
    return worlds[name]


for name, (wname, S, over, kw) in spec["cases"].items():
    _, idx, reads = world(wname)
    cfg = MapperConfig.from_index(idx, **{"both_strands": True, **over})
    m = Mapper(idx, cfg, topology="mesh", n_shards=S, **kw)
    keep(name, m.map(reads))

ref, idx, reads = world("main")
m = Mapper(idx, MapperConfig.from_index(idx, both_strands=True,
                                        stage_b_adaptive=True,
                                        stage_b_history=4),
           topology="mesh", n_shards=4)
for i, (lo, hi) in enumerate(spec["adaptive"]):
    cap = m.plan(hi - lo).stage_b_affine_cap
    keep(f"adaptive{i}", m.map(reads[lo:hi]), aff_cap=cap)

mesh8 = make_genomics_mesh(8)
sidx = shard_index(idx, 8)
pos, dist, dropped, st = distributed_map_reads(
    mesh8, sidx, reads[:64], with_stats=True)
arrays["legacy/position"], arrays["legacy/distance"] = pos, dist
arrays["legacy/dropped"] = np.asarray(dropped)
meta["legacy"] = {k: np.asarray(v).tolist() for k, v in st.items()}

svc_m = Mapper(idx, MapperConfig.from_index(idx, both_strands=True),
               topology="mesh", n_shards=4)
svc = MappingService(svc_m, batcher=BatcherConfig(bucket_min=16,
                                                  bucket_max=32))
meta["service"] = []
for p in range(2):
    rids = [svc.submit(reads[:40]), svc.submit(reads[40:])]
    out = svc.flush()
    for j, rid in enumerate(rids):
        for f in ("position", "distance", "distance2", "strand"):
            arrays[f"service{p}_{j}/{f}"] = np.asarray(getattr(out[rid], f))
    meta["service"].append([svc_m.plan_cache_hits, svc_m.plan_cache_misses])
meta["service_totals"] = {k: int(v) for k, v in svc.totals.items()}

parts = shard_flat_index(idx, 4, ref=ref)
keep("partitions4", Mapper(parts, MapperConfig.from_index(
    idx, both_strands=True), topology="mesh", n_shards=4).map(reads))

inj = jres.FaultInjector.from_spec(spec["inject"])
rm = Mapper(idx, MapperConfig.from_index(idx, both_strands=True,
                                         engine="fused"),
            topology="mesh", n_shards=2, send_cap=512)
res = jres.ResilientMapper(rm, jres.RetryPolicy(
    max_attempts=2, backoff_s=0.0, bisect_min=4, degrade_after=1),
    injector=inj)
for i, (lo, hi) in enumerate(((0, 65), (0, 24))):
    got, mask, counters = res.map(reads[lo:hi])
    arrays[f"resilient{i}/mask"] = mask
    keep(f"resilient{i}", got, counters=counters, level=res.ladder.level,
         engine=res.cfg.engine)
np.savez(spec["out"], _json=np.array(json.dumps(meta)), **arrays)
print("REFERENCE_MESH_OK")
'''

INJECT = "engines=fused,poison=17,bucket=0.2,seed=4"


def _make_world():
    ns = {}
    exec(WORLD_SRC, ns)
    return ns["make_world"]


make_world = _make_world()


@pytest.fixture(scope="module")
def worlds():
    """{name: (reference, reference index, port index, reads)}."""
    out = {}
    for name in ("main", "k16", "k16_norun"):
        ref, jidx, reads = make_world(name)
        tidx = GenomeIndex.from_arrays(
            jidx.uniq_kmers, jidx.offsets, jidx.positions, jidx.segments,
            read_len=jidx.read_len, k=jidx.k, w=jidx.w, eth=jidx.eth)
        out[name] = ref, jidx, tidx, reads
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's mesh runs on 8 forced host devices: (arrays,
    meta)."""
    out = tmp_path_factory.mktemp("ref_mesh") / "ref.npz"
    spec = dict(cases=CASES, adaptive=ADAPTIVE, stats=STATS,
                unified=UNIFIED, inject=INJECT, out=str(out))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT,
                           json.dumps(spec)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "REFERENCE_MESH_OK" in proc.stdout
    z = np.load(out)
    return {k: z[k] for k in z.files if k != "_json"}, \
        json.loads(str(z["_json"]))


def _cfg(tidx, **over):
    return MapperConfig.from_index(tidx, **{"both_strands": True, **over})


def _assert_run(got, name, reference):
    arrays, meta = reference
    for f in RESULT_FIELDS:
        want = arrays.get(f"{name}/{f}")
        v = getattr(got, f)
        assert (v is None) == (want is None), (name, f)
        if want is not None:
            np.testing.assert_array_equal(v, want, err_msg=f"{name} {f}")
    m = meta[name]
    assert {k: np.asarray(got.stats[k]).tolist() for k in STATS} == \
        m["stats"], name
    assert {k: int(getattr(got.stats, k)) for k in UNIFIED} == \
        m["unified"], name
    assert got.stats.get("partitions") == m["partitions"], name


# -------------------------------------------------------------- the index

@pytest.mark.parametrize("world", ["main", "k16"])
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_shard_index_is_the_references_byte_for_byte(worlds, world, S):
    _, jidx, tidx, _ = worlds[world]
    want, got = jdist.shard_index(jidx, S), tdist.shard_index(tidx, S)
    for f in SHARD_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert (got.n_shards, got.read_len, got.k, got.w, got.eth) == \
        (want.n_shards, want.read_len, want.k, want.w, want.eth)


def test_mesh_placed_partitions_equal_shard_index(worlds):
    """Partition i of a 4-partition ``shard_flat_index`` on shard i: the
    reference's stacked arrays, and ``shard_index``'s."""
    ref, jidx, tidx, _ = worlds["main"]
    got = shard_flat_index(tidx, 4, ref=ref).to_mesh_shards()
    want = jshard_flat(jidx, 4, ref=ref).to_mesh_shards()
    flat = tdist.shard_index(tidx, 4)
    for f in SHARD_FIELDS:
        a = getattr(got, f)
        for b in (getattr(want, f), getattr(flat, f)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


# ------------------------------------------------------------- the stages

@pytest.mark.parametrize("cap", [1, 3, 64])
def test_bucket_by_dst_matches_reference(cap):
    """Entries past ``cap`` in a group are dropped (counted), entries
    addressed to ``n_shards`` are not sent and not counted; the port
    buckets two local shards' entries in one call, each equal to the
    reference's bucketing of that shard's."""
    rng = np.random.default_rng(cap)
    L, S, E = 2, 4, 40
    dst = rng.integers(0, S + 1, (L, E)).astype(np.int32)
    kmer = rng.integers(0, 2**32, (L, E), dtype=np.uint64)
    read = rng.integers(0, 4, (L, E, 7)).astype(np.uint8)
    rid = np.broadcast_to(np.arange(E, dtype=np.int32), (L, E))
    got, gdrop = tdist._bucket_by_dst(
        torch.from_numpy(dst.astype(np.int64)),
        {"kmer": torch.from_numpy(kmer.astype(np.int64)),
         "read": torch.from_numpy(read),
         "rid": torch.from_numpy(rid.astype(np.int64))}, S, cap)
    for i in range(L):
        want, wdrop = jdist._bucket_by_dst(
            jdist.jnp.asarray(dst[i]), {"kmer": jdist.jnp.asarray(
                kmer[i].astype(np.uint32)), "read": jdist.jnp.asarray(
                read[i]), "rid": jdist.jnp.asarray(rid[i])}, S, cap)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k][i].numpy(),
                                          np.asarray(want[k]),
                                          err_msg=f"{k}, shard {i}")
        assert int(gdrop[i]) == int(wdrop)
        assert int(gdrop[i]) == int(sum(max((dst[i] == s).sum() - cap, 0)
                                        for s in range(S)))


@pytest.mark.parametrize("aff_cap", [8, None])
def test_stage_b_matches_reference(worlds, aff_cap):
    """The reference's stage B shard by shard, the port's over all four
    shards at once, on the same received entries (the main world's reads
    bucketed by the reference): affine distances, positions, co-optimal
    estimates, survivors and affine drops."""
    from repro.core.minimizers import hash32, unique_read_minimizers
    jnp = jdist.jnp
    _, jidx, tidx, reads = worlds["main"]
    S, cap = 4, 256
    jcfg = JConfig.from_index(jidx)
    tcfg = MapperConfig.from_index(tidx)
    if aff_cap is None:
        aff_cap = jdist.stage_b_affine_capacity(cap, jcfg)
    kmers, minipos, valid = jdist.jax.vmap(
        lambda r: unique_read_minimizers(r, k=jcfg.k, w=jcfg.w,
                                         max_uniq=jcfg.max_minis))(
        jnp.asarray(reads))
    dst = jnp.where(valid, (hash32(kmers) % S).astype(jnp.int32), S)
    M = jcfg.max_minis
    buckets, _ = jdist._bucket_by_dst(
        dst.reshape(-1), {
            "kmer": kmers.reshape(-1),
            "minipos": minipos.reshape(-1).astype(jnp.int32),
            "read": jnp.broadcast_to(jnp.asarray(reads)[:, None],
                                     (len(reads), M, 150)).reshape(-1, 150)},
        S, cap)
    jsh = jdist.shard_index(jidx, S)
    tsh = tdist.shard_index(tidx, S)
    got = tdist._stage_b(
        {"kmer": torch.from_numpy(np.asarray(buckets["kmer"])
                                  .astype(np.int64)),
         "minipos": torch.from_numpy(np.asarray(buckets["minipos"])
                                     .astype(np.int64)),
         "read": torch.from_numpy(np.array(buckets["read"])),
         "valid": torch.from_numpy(np.array(buckets["valid"]))},
        *tsh.device_arrays("cpu"), tcfg, aff_cap)
    for d in range(S):
        local = {k: v[d][None] for k, v in buckets.items()}
        want = jdist._stage_b(local, *(jnp.asarray(a[d]) for a in (
            jsh.uniq_kmers, jsh.offsets, jsh.positions, jsh.segments)),
            jcfg, aff_cap)
        for i, what in enumerate(("aff", "pos", "co_est")):
            np.testing.assert_array_equal(got[i][d].numpy(),
                                          np.asarray(want[i])[0],
                                          err_msg=f"shard {d} {what}")
        assert int(got[3][d]) == int(want[3])
        assert int(got[4][d]) == int(want[4])
    if aff_cap == 8:
        assert int(got[4].sum()) > 0            # survivors were dropped


# ---------------------------------------------------------- the mesh session

@pytest.mark.parametrize("case", list(CASES))
def test_mesh_mapper_matches_reference(worlds, reference, case):
    wname, S, over, kw = CASES[case]
    _, _, tidx, reads = worlds[wname]
    got = Mapper(tidx, _cfg(tidx, **over), topology="mesh", n_shards=S,
                 device="cpu", **kw).map(reads)
    _assert_run(got, case, reference)
    st = got.stats
    if case == "s8_send_cap_2":
        assert st.dropped_send > 0
    elif case == "s8_survivor_frac":
        assert st.dropped_affine > 0
    else:
        assert st.dropped_send == st.dropped_affine == 0
    if wname.startswith("k16"):                 # the poly-T read
        assert got.mapped[-1] == (wname == "k16")


def test_adaptive_capacity_and_plan_cache_match_reference(worlds,
                                                          reference):
    """An adaptive session's survivor capacity follows its history; a new
    capacity is a new plan (a miss), an unchanged one a hit — the
    reference's counts over the same calls."""
    _, _, tidx, reads = worlds["main"]
    m = Mapper(tidx, _cfg(tidx, stage_b_adaptive=True, stage_b_history=4),
               topology="mesh", n_shards=4, device="cpu")
    caps = []
    for i, (lo, hi) in enumerate(ADAPTIVE):
        cap = m.plan(hi - lo).stage_b_affine_cap
        assert cap == reference[1][f"adaptive{i}"]["aff_cap"]
        caps.append(cap)
        _assert_run(m.map(reads[lo:hi]), f"adaptive{i}", reference)
    assert len(set(caps)) > 1                   # the capacity moved


def test_distributed_map_reads_matches_reference(worlds, reference):
    arrays, meta = reference
    _, _, tidx, reads = worlds["main"]
    mesh = make_genomics_mesh(8, device="cpu")
    sidx = tdist.shard_index(tidx, 8)
    with pytest.warns(DeprecationWarning, match="Mapper"):
        pos, dist, dropped, st = tdist.distributed_map_reads(
            mesh, sidx, reads[:64], with_stats=True)
    np.testing.assert_array_equal(pos, arrays["legacy/position"])
    np.testing.assert_array_equal(dist, arrays["legacy/distance"])
    np.testing.assert_array_equal(dropped, arrays["legacy/dropped"])
    assert {k: np.asarray(v).tolist() for k, v in st.items()} == \
        meta["legacy"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError, match="multiple of the shard"):
            tdist.distributed_map_reads(mesh, sidx, reads[:63])
        cfg = _cfg(tidx, stage_b_survivor_frac=0.001, aff_block_r=8)
        with pytest.warns(UserWarning, match="dropped"):
            tdist.distributed_map_reads(mesh, sidx, reads[:64], cfg=cfg)


def test_mesh_service_matches_reference(worlds, reference):
    """The service on a 4-shard mesh, fed the same two requests twice:
    each request's rows equal the reference's, and the second pass is
    pure plan-cache hits."""
    arrays, meta = reference
    _, _, tidx, reads = worlds["main"]
    m = Mapper(tidx, _cfg(tidx), topology="mesh", n_shards=4, device="cpu")
    svc = MappingService(m, batcher=BatcherConfig(bucket_min=16,
                                                  bucket_max=32))
    for p in range(2):
        rids = [svc.submit(reads[:40]), svc.submit(reads[40:])]
        out = svc.flush()
        for j, rid in enumerate(rids):
            for f in ("position", "distance", "distance2", "strand"):
                np.testing.assert_array_equal(
                    getattr(out[rid], f), arrays[f"service{p}_{j}/{f}"],
                    err_msg=f"pass {p} request {j} {f}")
        assert [m.plan_cache_hits, m.plan_cache_misses] == \
            meta["service"][p]
    assert meta["service"][1][1] == meta["service"][0][1]   # no new miss
    assert {k: int(v) for k, v in svc.totals.items()} == \
        meta["service_totals"]
    assert svc.totals["reads"] == 2 * len(reads)


def test_mesh_placed_partitions_map_as_reference(worlds, reference):
    ref, _, tidx, reads = worlds["main"]
    parts = shard_flat_index(tidx, 4, ref=ref)
    got = Mapper(parts, _cfg(tidx), topology="mesh", n_shards=4,
                 device="cpu").map(reads)
    _assert_run(got, "partitions4", reference)
    flat = Mapper(tidx, _cfg(tidx), topology="mesh", n_shards=4,
                  device="cpu").map(reads)
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(flat, f))
    with pytest.raises(ValueError, match="4 partitions but the mesh has 2"):
        Mapper(parts, topology="mesh", n_shards=2, device="cpu")


def test_resilient_mesh_rung_matches_reference(worlds, reference):
    """A failing fused engine steps the mesh session's ladder down to its
    compacted rung — ``Mapper.with_config`` on the same mesh, shards and
    ``send_cap`` — with the reference's masks, counters and results."""
    arrays, meta = reference
    _, _, tidx, reads = worlds["main"]
    base = Mapper(tidx, _cfg(tidx, engine="fused"), topology="mesh",
                  n_shards=2, device="cpu", send_cap=512)
    rm = tres.ResilientMapper(base, tres.RetryPolicy(
        max_attempts=2, backoff_s=0.0, bisect_min=4, degrade_after=1),
        injector=tres.FaultInjector.from_spec(INJECT))
    for i, (lo, hi) in enumerate(((0, 65), (0, 24))):
        got, mask, counters = rm.map(reads[lo:hi])
        np.testing.assert_array_equal(mask, arrays[f"resilient{i}/mask"])
        m = meta[f"resilient{i}"]
        assert counters == m["counters"]
        assert (rm.ladder.level, rm.cfg.engine) == (m["level"], m["engine"])
        for f in RESULT_FIELDS:
            np.testing.assert_array_equal(getattr(got, f),
                                          arrays[f"resilient{i}/{f}"],
                                          err_msg=f"block {i} {f}")
    rung = rm._mapper_at(rm.ladder.level)
    assert rung is not base and rung.mesh is base.mesh
    assert rung.send_cap == 512 and rung._dev is base._dev


def test_registry_totals_match_reference(worlds):
    """Mesh runs mirrored into the metrics registry: the
    ``topology="mesh"`` counters and ``totals_from_registry("mesh")``
    equal the reference's (both record a both-strands run's stacked
    batch, before the strand reduce), and the engine fields the launchers
    take from the registry equal the runs' own stats."""
    from repro.core.mapper import Mapper as JMapper
    from repro.core.mapper import totals_from_registry as jtotals
    from repro.obs import registry as jreg
    from repro_torch.core.mapper import accumulate_stats, totals_from_registry
    from repro_torch.obs import registry as treg
    _, jidx, tidx, reads = worlds["main"]
    jr = jreg.enable_metrics(jreg.MetricsRegistry())
    tr = treg.enable_metrics(treg.MetricsRegistry())
    try:
        jm = JMapper(jidx, JConfig.from_index(jidx, both_strands=True),
                     topology="mesh", n_shards=1)
        tm = Mapper(tidx, _cfg(tidx), topology="mesh", device="cpu")
        engine = ("survivors", "affine_instances",
                  "padded_affine_instances", "dropped_send",
                  "dropped_affine")
        totals = {}
        for batch in (reads, reads[:40], reads):
            jm.map(batch)
            accumulate_stats(totals, tm.map(batch).stats, fields=engine)
        got = totals_from_registry("mesh", tr)
        assert got == jtotals("mesh", jr)
        assert {k: got[k] for k in engine} == totals
        for c in ("repro_plan_cache_hits_total",
                  "repro_plan_cache_misses_total"):
            assert tr.counter(c, topology="mesh").value == \
                jr.counter(c, topology="mesh").value
    finally:
        jreg.disable_metrics()
        treg.disable_metrics()


@pytest.mark.parametrize("bare", [True, False])
def test_closing_report_matches_reference(worlds, bare):
    """The launchers' closing stats lines of a one-shard mesh session equal
    the reference's: on a bare ``ShardedIndex`` (no host index, so no
    footprint line) and on the flat index it was sharded from (whose
    footprint line counts the port's int64 offsets and positions, so
    only its presence is compared)."""
    import io

    from repro.core.mapper import Mapper as JMapper
    from repro.core.mapper import accumulate_stats as jaccumulate
    from repro.launch.serve import _print_mapper_stats
    from repro_torch.core.mapper import accumulate_stats
    from repro_torch.launch.report import print_mapper_stats
    _, jidx, tidx, reads = worlds["main"]
    jsrc = jdist.shard_index(jidx, 1) if bare else jidx
    tsrc = tdist.shard_index(tidx, 1) if bare else tidx
    jm = JMapper(jsrc, JConfig.from_index(jidx, both_strands=True),
                 topology="mesh", n_shards=1)
    tm = Mapper(tsrc, _cfg(tidx), topology="mesh", n_shards=1,
                device="cpu")
    assert (tm.index_storage() is None) == bare
    out = []
    for m, acc, print_stats in ((jm, jaccumulate, _print_mapper_stats),
                                (tm, accumulate_stats, print_mapper_stats)):
        totals = {}
        for batch in (reads, reads):
            acc(totals, m.map(batch).stats, fields=(
                "survivors", "affine_instances", "padded_affine_instances",
                "dropped_send", "dropped_affine"))
        buf = io.StringIO()
        print_stats(m, totals, file=buf)
        out.append(buf.getvalue())
    got, want = ([ln for ln in o.splitlines()
                  if not ln.startswith("index storage:")] for o in out)
    assert got == want and len(got) == 2
    for o in out:
        assert ("index storage:" in o) != bare


def test_positions_past_2_30_map_where_the_reference_drops_them(worlds):
    """The documented difference of stage C's tie key: with every
    position moved up by 2^30 (still int32), the port maps each read at
    its position plus 2^30 where the reference's ``2**30`` sentinel
    returns -1 for it; distances agree."""
    from repro.core.mapper import Mapper as JMapper
    _, jidx, tidx, reads = worlds["main"]
    js, ts = jdist.shard_index(jidx, 1), tdist.shard_index(tidx, 1)
    lift = dict(positions=js.positions + np.int32(2**30))
    js2 = jdist.ShardedIndex(**{**js.__dict__, **lift})
    ts2 = tdist.ShardedIndex(**{**ts.__dict__, **lift})
    want = JMapper(js2, JConfig.from_index(jidx), topology="mesh",
                   n_shards=1).map(reads)
    got = Mapper(ts2, MapperConfig.from_index(tidx), topology="mesh",
                 device="cpu").map(reads)
    base = Mapper(ts, MapperConfig.from_index(tidx), topology="mesh",
                  device="cpu").map(reads)
    np.testing.assert_array_equal(got.distance, want.distance)
    hit = base.position >= 0
    assert hit.sum() > 20               # the forward-strand reads
    np.testing.assert_array_equal(got.position[hit],
                                  base.position[hit] + 2**30)
    assert (want.position == -1).all()


# -------------------------------------------------------- the mesh's forms

def test_mesh_refusals_and_forms(worlds, monkeypatch):
    _, _, tidx, reads = worlds["main"]
    sidx = tdist.shard_index(tidx, 2)
    with pytest.raises(ValueError, match="2 shards but the mesh has 4"):
        Mapper(sidx, topology="mesh", n_shards=4, device="cpu")
    with pytest.raises(ValueError, match='topology="single" needs a '
                                         "GenomeIndex"):
        Mapper(sidx, device="cpu")
    for kw in (dict(memory_budget_bytes=1 << 20), dict(prefetch=True)):
        with pytest.raises(ValueError, match="only applies to topology="):
            Mapper(tidx, topology="mesh", device="cpu", **kw)
    with monkeypatch.context() as mp:       # no device: the card or raise
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Mapper(tidx, topology="mesh", n_shards=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_genomics_mesh(2)
    mesh = make_genomics_mesh(device="cpu")
    assert (mesh.n_shards, mesh.local, mesh.group) == (1, (0,), None)
    m = Mapper(sidx, topology="mesh", mesh=make_genomics_mesh(2,
                                                              device="cpu"))
    assert m.index_storage() is None and m.device.type == "cpu"
    plan = m.plan(len(reads))
    assert plan.key == ("mesh", 66, plan.send_cap, plan.stage_b_affine_cap)
    x = torch.arange(2 * 3 * 5).view(2, 3, 5)
    assert torch.equal(tdist.LocalExchange().all_to_all(x[:, :2]),
                       x[:, :2].transpose(0, 1))


_GLOO_SCRIPT = WORLD_SRC + r'''
import socket, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, world, port, q):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    from repro_torch.core.index import GenomeIndex
    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pipeline import MapperConfig
    from repro_torch.launch.mesh import make_genomics_mesh
    _, jidx, reads = make_world("main")
    idx = GenomeIndex.from_arrays(jidx.uniq_kmers, jidx.offsets,
                                  jidx.positions, jidx.segments,
                                  read_len=150, k=12, w=30, eth=6)
    for over, kw in (({}, {}), ({"both_strands": False}, {"send_cap": 2})):
        cfg = MapperConfig.from_index(idx, **{"both_strands": True, **over})
        mesh = make_genomics_mesh(device="cpu", group=dist.group.WORLD)
        assert mesh.local == (rank,) and mesh.n_shards == world
        got = Mapper(idx, cfg, topology="mesh", mesh=mesh, **kw).map(reads)
        if rank == 0:
            want = Mapper(idx, cfg, topology="mesh", n_shards=world,
                          device="cpu", **kw).map(reads)
            for f in ("position", "distance", "distance2", "mapped",
                      "strand"):
                a, b = getattr(got, f), getattr(want, f)
                assert (a is None) == (b is None), f
                assert a is None or np.array_equal(a, b), f
            for k in want.stats.keys():
                if k != "stage_times_s":
                    assert np.array_equal(got.stats[k], want.stats[k]), k
            assert kw.get("send_cap") is None or got.stats.dropped_send > 0
    if rank == 0:
        q.put("GLOO_MESH_OK")
    dist.destroy_process_group()


if __name__ == "__main__":
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    q = mp.get_context("spawn").Queue()
    mp.spawn(rank_main, args=(4, port, q), nprocs=4, join=True)
    print(q.get())
'''


def test_gloo_group_of_four_equals_the_local_form(tmp_path):
    """One shard per rank over 4 gloo ranks on the CPU: every rank maps
    the whole batch, the exchange is ``all_to_all_single`` and the
    results are gathered; rank 0's equal the 4-shard local form's, with
    and without send drops."""
    script = tmp_path / "gloo_mesh.py"
    script.write_text(_GLOO_SCRIPT)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "GLOO_MESH_OK" in proc.stdout
