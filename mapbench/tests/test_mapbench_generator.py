"""The benchmark's generator: deterministic by seed, and its reads carry
the error process's rates."""
import pytest
import torch

from mapbench.harness import genome as gen

RATES = {"sub": 0.002, "ins": 0.0005, "del": 0.0005}


@pytest.fixture(scope="module")
def ref():
    return gen.make_reference(400_000, 0, 0.05, 1000, "cpu")


def test_reference_repeats_by_seed_and_holds_its_copies(ref):
    assert torch.equal(ref, gen.make_reference(400_000, 0, 0.05, 1000, "cpu"))
    assert not torch.equal(ref, gen.make_reference(400_000, 1, 0.05, 1000,
                                                   "cpu"))
    assert ref.dtype == torch.uint8 and int(ref.max()) == 3
    # the model drawn again by hand: the same first bases and copies
    g = torch.Generator()
    g.manual_seed(0)
    base = torch.randint(0, 4, (400_000,), generator=g, dtype=torch.uint8)
    src = torch.randint(0, 399_000, (20,), generator=g)
    dst = torch.randint(0, 399_000, (20,), generator=g)
    want = base.clone()
    for s, d in zip(src.tolist(), dst.tolist()):
        want[d:d + 1000] = base[s:s + 1000]
    assert torch.equal(ref, want)
    changed = float((ref != base).double().mean())
    assert 0.02 < changed < 0.05      # three quarters of a copy's bases move


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_reads_repeat_by_seed(ref, seed):
    a = gen.sample_reads(ref, 500, 150, RATES, 0.5, 0.1,
                         gen.generator(ref.device, seed, 1))
    b = gen.sample_reads(ref, 500, 150, RATES, 0.5, 0.1,
                         gen.generator(ref.device, seed, 1))
    c = gen.sample_reads(ref, 500, 150, RATES, 0.5, 0.1,
                         gen.generator(ref.device, seed + 1, 1))
    assert torch.equal(a.reads, b.reads) and torch.equal(a.start, b.start)
    assert not torch.equal(a.reads, c.reads)


def test_pairs_repeat_by_seed(ref):
    kw = dict(insert_mean=350, insert_sd=30, r2_foreign_frac=0.1)
    a = gen.sample_pairs(ref, 400, 150, RATES, g=gen.generator(
        ref.device, 5, 1), **kw)
    b = gen.sample_pairs(ref, 400, 150, RATES, g=gen.generator(
        ref.device, 5, 1), **kw)
    assert torch.equal(a.reads1, b.reads1) and torch.equal(a.reads2, b.reads2)


def test_error_rates(ref):
    n = 20_000
    r = gen.sample_reads(ref, n, 150, RATES, 0.0, 0.0,
                         gen.generator(ref.device, 3, 1))
    ev = r.events.double()
    steps = float(ev.sum())
    for code, key in ((gen.SUB, "sub"), (gen.INS, "ins"), (gen.DEL, "del")):
        p = RATES[key]
        sd = (p * (1 - p) / steps) ** 0.5
        assert abs(float(ev[code]) / steps - p) < 5 * sd, key
    assert r.reads.shape == (n, 150) and int(r.reads.max()) <= 3
    clean = (r.n_errors == 0).nonzero()[:, 0][:200]
    for i in clean.tolist():
        s = int(r.start[i])
        assert torch.equal(r.reads[i], ref[s:s + 150])


def test_reads_shares(ref):
    n = 20_000
    r = gen.sample_reads(ref, n, 150, RATES, 0.5, 0.9,
                         gen.generator(ref.device, 4, 1))
    foreign = float((r.start < 0).double().mean())
    assert abs(foreign - 0.9) < 0.02


def test_pairs_geometry(ref):
    n = 4000
    p = gen.sample_pairs(ref, n, 150, {"sub": 0, "ins": 0, "del": 0}, 350,
                         30, 0.1, gen.generator(ref.device, 9, 1))
    assert abs(float(p.isize.double().mean()) - 350) < 3
    assert int(p.isize.min()) >= 150 and int(p.isize.max()) <= 700
    assert abs(float(p.foreign2.double().mean()) - 0.1) < 0.02
    ok = ~p.foreign2
    # without errors each mate is the reference at its position, the
    # downstream one reverse-complemented
    for i in ok.nonzero()[:, 0][:100].tolist():
        for reads, pos in ((p.reads1, p.pos1), (p.reads2, p.pos2)):
            seg = ref[int(pos[i]):int(pos[i]) + 150]
            assert (torch.equal(reads[i], seg)
                    or torch.equal(reads[i], gen.revcomp(seg)))
        assert int(max(p.pos1[i], p.pos2[i]) + 150
                   - min(p.pos1[i], p.pos2[i])) == int(p.isize[i])
