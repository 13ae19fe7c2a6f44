"""The plain reference equals ``repro_torch`` on a tiny reference on the
CPU: every mapping field on both engines, and the paired resolution with
mate rescue.  (The test may import both; the reference may not.)"""

import numpy as np
import pytest
import torch

from mapbench.harness import genome as gen
from mapbench.reference import dp
from mapbench.reference.mapper import Geometry, Index, map_reads
from mapbench.reference.pairing import insert_windows, resolve

MAPPER = dict(read_len=150, k=12, w=30, eth=6, sat_affine=32, max_minis=16,
              max_pls=32, filter_threshold=6, both_strands=True,
              cigar_mode="eager", chunk_reads=32, wf_backend="cuda")
G = 200_000


@pytest.fixture(scope="module")
def world():
    from repro_torch.core.index import build_index
    ref = gen.make_reference(G, 0, 0.02, 500, "cpu").numpy()
    ref_t = torch.from_numpy(ref)
    g = gen.generator(ref_t.device, 21, 1)
    clean = gen.sample_reads(ref_t, 48, 150, {"sub": 0.002, "ins": 0.0005,
                                              "del": 0.0005}, 0.5, 0.0, g)
    # many edits, so the band, the gaps and the runner-up all do work
    noisy = gen.sample_reads(ref_t, 48, 150, {"sub": 0.015, "ins": 0.005,
                                              "del": 0.005}, 0.5, 0.1, g)
    reads = torch.cat([clean.reads, noisy.reads]).numpy()
    # a read that starts at the reference's first base
    reads[0] = ref[:150]
    idx = build_index(ref, device="cpu")
    want = map_reads(Index(ref_t, Geometry.of(MAPPER)), torch.from_numpy(
        reads))
    return ref, ref_t, idx, reads, want


@pytest.mark.parametrize("engine", ["compacted", "fused"])
def test_mapping_equals_the_port(world, engine):
    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pipeline import MapperConfig
    ref, ref_t, idx, reads, want = world
    res = Mapper(idx, MapperConfig(engine=engine, **MAPPER),
                 device="cpu").map(reads)
    assert want["mapped"].sum() > 50
    for f in ("position", "distance", "distance2", "mapped", "strand",
              "n_candidates", "op_count", "ops"):
        assert np.array_equal(np.asarray(getattr(res, f)), want[f]), f
    if engine == "compacted":
        assert np.array_equal(res.linear_dist, want["linear_dist"])
    assert res.stats.candidates == want["candidates"]
    assert res.stats.survivors == want["survivors"]


def test_dp_equals_the_ports_plain_versions():
    from repro_torch.core.affine_wf import banded_affine, traceback
    from repro_torch.core.linear_wf import banded_wf
    rng = np.random.default_rng(3)
    n, eth = 40, 4
    a = torch.from_numpy(rng.integers(0, 4, (300, n)).astype(np.uint8))
    b = torch.from_numpy(rng.integers(0, 5, (300, n + 2 * eth))
                         .astype(np.uint8))
    # half the windows close to their reads
    b[:150, eth:eth + n] = a[:150]
    b[:150, eth + 3] = 1
    assert torch.equal(dp.linear_distance(a, b, eth),
                       banded_wf(a, b, eth=eth)[0])
    for sat in (8, 16, 32):
        de, dirs = dp.affine(a, b, eth, sat, want_dirs=True)
        de2, _, dirs2 = banded_affine(a, b, eth=eth, sat=sat)
        assert torch.equal(de, de2) and torch.equal(dirs, dirs2)
        for mo in (5, 2 * n + 2):
            ops, cnt = dp.traceback(dirs, eth, mo)
            ops2, cnt2 = traceback(dirs2, eth, mo)
            assert torch.equal(ops, ops2) and torch.equal(cnt, cnt2)


@pytest.mark.parametrize("seed", [1, 2])
def test_dp_on_reads_with_many_indels(seed):
    from repro_torch.core.affine_wf import banded_affine, traceback
    from repro_torch.core.linear_wf import banded_wf
    ref = gen.make_reference(20_000, seed, 0.0, 500, "cpu")
    g = gen.generator(ref.device, seed, 2)
    r = gen.sample_reads(ref, 400, 60, {"sub": 0.02, "ins": 0.02,
                                        "del": 0.02}, 0.0, 0.0, g)
    eth = 5
    col = r.start[:, None] - eth + torch.arange(60 + 2 * eth)
    win = torch.where((col >= 0) & (col < len(ref)),
                      ref[torch.clamp(col, 0, len(ref) - 1)], 4).to(
                          torch.uint8)
    assert torch.equal(dp.linear_distance(r.reads, win, eth),
                       banded_wf(r.reads, win, eth=eth)[0])
    de, dirs = dp.affine(r.reads, win, eth, 32, want_dirs=True)
    de2, _, dirs2 = banded_affine(r.reads, win, eth=eth, sat=32)
    assert torch.equal(de, de2) and torch.equal(dirs, dirs2)
    assert torch.equal(dp.traceback(dirs, eth, 122)[0],
                       traceback(dirs2, eth, 122)[0])


def test_pairing_equals_the_port(world):
    """Mates mapped by the port, some of them unmapped on purpose so that
    rescue places them, resolved by the port and by the reference."""
    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pairing import InsertSizeTracker, resolve_pairs
    from repro_torch.core.pipeline import MapperConfig
    ref, ref_t, idx, _, _ = world
    p = gen.sample_pairs(ref_t, 48, 150, {"sub": 0.002, "ins": 0.0005,
                                          "del": 0.0005}, 350, 30, 0.1,
                         gen.generator(ref_t.device, 8, 1))
    r1, r2 = p.reads1.numpy(), p.reads2.numpy()
    cfg = MapperConfig(engine="fused", **MAPPER)
    res1, res2 = Mapper(idx, cfg, device="cpu").map_pairs(r1, r2)
    for res, rows in ((res1, slice(0, 6)), (res2, slice(6, 12))):
        res.mapped[rows] = False
        res.position[rows] = -1
    resolved = resolve_pairs(res1, res2, cfg=cfg, tracker=InsertSizeTracker(),
                       ref=ref_t, reads1=r1, reads2=r2, device="cpu")
    assert resolved.rescued1.sum() + resolved.rescued2.sum() >= 8
    g = Geometry.of(MAPPER)
    fields = ("position", "strand", "distance", "distance2", "mapped")
    m1 = {f: np.asarray(getattr(res1, f)) for f in fields}
    m2 = {f: np.asarray(getattr(res2, f)) for f in fields}
    windows = insert_windows(m1["position"], m1["strand"], m1["mapped"],
                             m2["position"], m2["strand"], m2["mapped"], 150)
    want = resolve(ref_t, g, m1, m2, r1, r2, [windows] * len(r1))
    for f in ("proper", "insert", "mapq1", "mapq2", "rescued1", "rescued2"):
        assert np.array_equal(getattr(resolved, f), want[f]), f
    for t, res in ((1, resolved.res1), (2, resolved.res2)):
        for f in fields:
            assert np.array_equal(np.asarray(getattr(res, f)),
                                  want[f"{f}_{t}"]), (f, t)
    assert tuple(resolved.stats["insert_window"]) == windows[0]


def test_reference_window_from_its_own_tail(world, monkeypatch):
    """The reference's insert window, from its own mapping of a batch's last
    pairs block by block, is the window of its mapping of the whole batch,
    and the port's tracker's window on the same pairs."""
    from mapbench.entries import map_pairs as entry
    from mapbench.reference import pairing
    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pairing import InsertSizeTracker, resolve_pairs
    from repro_torch.core.pipeline import MapperConfig
    ref, ref_t, idx, _, _ = world
    p = gen.sample_pairs(ref_t, 96, 150, {"sub": 0.002, "ins": 0.0005,
                                          "del": 0.0005}, 350, 30, 0.1,
                         gen.generator(ref_t.device, 9, 1))
    r1, r2 = p.reads1.numpy(), p.reads2.numpy()
    ix = Index(ref_t, Geometry.of(MAPPER))
    whole = [map_reads(ix, torch.from_numpy(r)) for r in (r1, r2)]
    args = [whole[t][f] for t in (0, 1)
            for f in ("position", "strand", "mapped")]
    for keep, block in ((pairing.KEEP_INSERTS, entry.TAIL_BLOCK), (40, 16)):
        monkeypatch.setattr(pairing, "KEEP_INSERTS", keep)
        monkeypatch.setattr(entry, "TAIL_BLOCK", block)
        assert entry.own_windows(ix, r1, r2) == pairing.insert_windows(
            *args, 150)
    monkeypatch.undo()
    cfg = MapperConfig(engine="fused", **MAPPER)
    res1, res2 = Mapper(idx, cfg, device="cpu").map_pairs(r1, r2)
    resolved = resolve_pairs(res1, res2, cfg=cfg, tracker=InsertSizeTracker(),
                             ref=ref_t, reads1=r1, reads2=r2, device="cpu")
    assert tuple(resolved.stats["insert_window"]) == entry.own_windows(
        ix, r1, r2)[0]
