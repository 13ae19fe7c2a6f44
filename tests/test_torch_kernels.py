"""The port's kernel wrappers (``repro_torch.kernels.ops``) on CPU tensors,
where they run the kernels' plain torch versions, against the reference's
Pallas kernels in interpret mode (``repro.kernels.ops``) and its jnp
versions.  The mapper is integer arithmetic: equality is exact."""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import affine_wf as jaff
from repro.kernels import ops as jops
from repro_torch.core import affine_wf as taff
from repro_torch.core import wf_backend as twfb
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import ops as tops

ETH, SAT = 6, 32


def _pair_batch(rng, R, n, eth, top=4):
    """Random and near-match pairs (the reference kernel tests' generator),
    of bytes below ``top``."""
    s1 = rng.integers(0, top, (R, n)).astype(np.uint8)
    s2 = rng.integers(0, top, (R, n + 2 * eth)).astype(np.uint8)
    s2[: R // 2, eth : eth + n] = s1[: R // 2]
    for r in range(R // 2):
        for _ in range(int(rng.integers(0, 4))):
            s2[r, eth + int(rng.integers(0, n))] = rng.integers(0, top)
    return s1, s2


def _edited_pair(r, n, n_edits):
    """Read + window with ``n_edits`` substitutions/indels: many edits walk
    the band edges and make adjacent gap runs (the reference traceback
    tests' generator)."""
    s1 = r.integers(0, 4, n).astype(np.uint8)
    lst = list(np.concatenate([r.integers(0, 4, ETH), s1,
                               r.integers(0, 4, ETH)]))
    for _ in range(n_edits):
        p = int(r.integers(ETH, ETH + n - 2))
        t = int(r.integers(0, 3))
        if t == 0:
            lst[p] = int(r.integers(0, 4))
        elif t == 1:
            lst.insert(p, int(r.integers(0, 4)))
        else:
            del lst[p]
    win = np.array((lst + [0] * (n + 2 * ETH))[: n + 2 * ETH], dtype=np.uint8)
    return s1, win


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, what):
    for g, w, name in zip(got, want, ("0", "1", "2", "3")):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what}[{name}]")


_LINEAR_CASES = [
    (33, 24, 6, 4), (64, 40, 6, 4), (128, 50, 4, 4), (16, 30, 8, 4),
    (21, 24, 6, 4),
    # the ends and the middle of the compiled range (ops.SUPPORTED_ETH)
    (24, 30, 0, 4), (24, 30, 5, 4), (24, 30, 12, 4),
    # reads no longer than the band and just past it: the rows whose band
    # reaches left of column 0 are all of them, or all but the last
    (16, 1, 12, 4), (16, 12, 12, 4), (16, 13, 12, 4), (17, 7, 6, 4),
    # any byte: the wrappers take uint8 reads and windows, SENTINEL and up
    (19, 29, 6, 256),
]


@pytest.mark.parametrize(
    "R,n,eth,top", _LINEAR_CASES,
    ids=[f"{R}-{n}-{eth}" + (f"-bytes{top}" if top != 4 else "")
         for R, n, eth, top in _LINEAR_CASES])
def test_linear_wf_matches_pallas(R, n, eth, top):
    s1, s2 = _pair_batch(np.random.default_rng(R * n + eth), R, n, eth, top)
    want = jops.linear_wf(jnp.array(s1), jnp.array(s2), eth=eth,
                          block_r=16 if R < 32 else 32)
    got = tops.linear_wf(_t(s1), _t(s2), eth=eth)
    assert got[0].dtype == torch.int32
    _eq([g.numpy() for g in got], want, "linear_wf")


@pytest.mark.parametrize("R,n,eth,sat", [
    (17, 24, 6, 32), (32, 40, 4, 16), (64, 30, 6, 32),
    (24, 30, 0, 32), (24, 30, 5, 16), (24, 30, 12, 32),
])
def test_affine_wf_dist_matches_pallas(R, n, eth, sat):
    s1, s2 = _pair_batch(np.random.default_rng(R + n), R, n, eth)
    want = jops.affine_wf_dist(jnp.array(s1), jnp.array(s2), eth=eth,
                               sat=sat, block_r=32)
    got = tops.affine_wf_dist(_t(s1), _t(s2), eth=eth, sat=sat)
    _eq([g.numpy() for g in got], want, "affine_wf_dist")


@pytest.mark.parametrize("R,n,eth,sat", [
    (17, 24, 6, 32), (32, 40, 4, 16),
])
def test_affine_direction_bytes_match_pallas(R, n, eth, sat):
    """The plain forward pass's direction bytes (what the fused kernel
    keeps in shared memory) against the Pallas dirs-emitting kernel."""
    s1, s2 = _pair_batch(np.random.default_rng(R * 3 + n), R, n, eth)
    want = jops.affine_wf(jnp.array(s1), jnp.array(s2), eth=eth, sat=sat,
                          block_r=32)
    got = taff.banded_affine(_t(s1), _t(s2), eth=eth, sat=sat)
    _eq([g.numpy() for g in got], want, "banded_affine")


def _traceback_cases():
    r = np.random.default_rng(7)
    edited = [_edited_pair(r, 24, e) for e in (0, 1, 2, 3, 4, 5, 6, 8)]
    near = _pair_batch(np.random.default_rng(3), 10, 24, ETH)
    n = 12
    origin = np.array([0, 1, 2, 3] * 5, dtype=np.uint8)
    edge = np.full(ETH, 4, np.uint8)
    exact = origin[:n]
    gap_read = np.concatenate([origin[:4], [3, 3], origin[4:10]]).astype(
        np.uint8)
    win = np.concatenate([edge, origin[:n], edge])
    degenerate = (np.stack([exact, gap_read]), np.stack([win, win]))
    return {
        "band_edges": (np.stack([a for a, _ in edited]),
                       np.stack([b for _, b in edited])),
        "random_and_near": near,
        "all_match_and_adjacent_gaps": degenerate,
    }


_TB = _traceback_cases()


@pytest.mark.parametrize("case", sorted(_TB))
@pytest.mark.parametrize("wrap", [False, True])
def test_affine_traceback_matches_pallas(case, wrap):
    """Fused affine + traceback: distances, END-aligned ops and counts,
    also with a ``max_ops`` shorter than the walks (later ops overwrite
    earlier ones modulo ``max_ops``)."""
    s1, s2 = _TB[case]
    n = s1.shape[1]
    max_ops = 9 if wrap else 2 * n + 2
    want = jops.affine_traceback(jnp.array(s1), jnp.array(s2), eth=ETH,
                                 sat=SAT, max_ops=max_ops, block_r=8)
    got = tops.affine_traceback(_t(s1), _t(s2), eth=ETH, sat=SAT,
                                max_ops=max_ops)
    _eq([g.numpy() for g in got], want, f"affine_traceback[{case}]")
    # and the jnp reference pair (banded_affine + batched walk)
    de, dm, dirs = jaff.banded_affine(jnp.array(s1), jnp.array(s2), eth=ETH,
                                      sat=SAT)
    ops_, cnt = jaff.traceback(dirs, ETH, max_ops)
    _eq([g.numpy() for g in got], (de, dm, ops_, cnt), "jnp traceback")


@pytest.mark.parametrize("eth", [0, 5, 12])
def test_affine_traceback_matches_pallas_at_eth(eth):
    """The fused affine + traceback wrapper at the ends and the middle of
    the compiled eth range, on random and near-match pairs."""
    s1, s2 = _pair_batch(np.random.default_rng(40 + eth), 24, 30, eth)
    max_ops = 2 * 30 + 2
    want = jops.affine_traceback(jnp.array(s1), jnp.array(s2), eth=eth,
                                 sat=SAT, max_ops=max_ops, block_r=8)
    got = tops.affine_traceback(_t(s1), _t(s2), eth=eth, sat=SAT,
                                max_ops=max_ops)
    _eq([g.numpy() for g in got], want, f"affine_traceback eth={eth}")


def test_all_match_and_gap_runs_decode():
    """The degenerate batch walks as the reference's own test expects: a
    straight diagonal, and a 2-insertion run next to a 2-deletion run."""
    s1, s2 = _TB["all_match_and_adjacent_gaps"]
    n = s1.shape[1]
    de, _, ops_, cnt = twfb.affine_traceback(_t(s1), _t(s2), eth=ETH, sat=SAT,
                                             max_ops=2 * n + 2)
    ops_, cnt = ops_.numpy(), cnt.numpy()
    assert int(de[0]) == 0 and int(cnt[0]) == n
    assert (ops_[0, -n:] == taff.OP_MATCH).all()
    walk = [int(o) for o in ops_[1] if o != taff.OP_NONE]
    assert int(de[1]) == 6 and len(walk) == int(cnt[1])
    text = "".join("=XID"[o] for o in walk)
    assert "II" in text and "DD" in text


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_wf_backend_leading_dims(backend):
    """Both backends take arbitrary leading batch dims and agree."""
    s1, s2 = _pair_batch(np.random.default_rng(5), 12, 20, ETH)
    a, b = _t(s1).reshape(3, 4, 20), _t(s2).reshape(3, 4, 32)
    de, dm = twfb.linear_wf_dist(a, b, eth=ETH, backend=backend)
    ae, am = twfb.affine_wf_dist(a, b, eth=ETH, sat=SAT, backend=backend)
    te, tm, ops_, cnt = twfb.affine_traceback(a, b, eth=ETH, sat=SAT,
                                              max_ops=42, backend=backend)
    assert de.shape == ae.shape == cnt.shape == (3, 4)
    assert ops_.shape == (3, 4, 42)
    want = jops.linear_wf(jnp.array(s1), jnp.array(s2), eth=ETH, block_r=16)
    np.testing.assert_array_equal(de.reshape(-1).numpy(), want[0])
    np.testing.assert_array_equal(ae.numpy(), te.numpy())
    np.testing.assert_array_equal(am.numpy(), tm.numpy())


def test_wrappers_reject_bad_input():
    s1 = torch.zeros((4, 10), dtype=torch.uint8)
    s2 = torch.zeros((4, 22), dtype=torch.uint8)
    with pytest.raises(TypeError):
        tops.linear_wf(s1.to(torch.int8), s2, eth=ETH)
    with pytest.raises(ValueError):
        tops.affine_wf_dist(s1, s2[:, :-1], eth=ETH)
    with pytest.raises(ValueError):
        tops.affine_traceback(s1, s2.t().contiguous().t(), eth=ETH,
                              max_ops=22)
    with pytest.raises(ValueError):
        tops.affine_traceback(s1, s2, eth=ETH, max_ops=0)
    with pytest.raises(ValueError):
        twfb.linear_wf_dist(s1, s2, eth=ETH, backend="pallas")
    # no launch happened on the CPU: the counters count kernels only
    assert tops.traceback_threads(150, 6) == 128
    with pytest.raises(ValueError):
        tops.traceback_threads(1000, 8)


def test_supported_eth_is_the_compiled_range():
    """``ops.SUPPORTED_ETH`` is 0..wf::MAX_ETH, the instances every WF
    kernel's entry point dispatches to through ``wf::by_eth`` (no
    hand-written case list that could fall behind)."""
    common = (tbuild.CSRC / "wf_common.cuh").read_text()
    m = re.search(r"constexpr int MAX_ETH = (\d+);", common)
    assert m and tops.SUPPORTED_ETH == tuple(range(int(m.group(1)) + 1))
    assert tops.SUPPORTED_ETH[-1] >= 12
    for lib in ("linear_wf", "affine_wf", "traceback"):
        src = (tbuild.CSRC / tbuild.SOURCES[lib]).read_text()
        assert "wf::by_eth(eth," in src and "case " not in src, lib


@pytest.mark.parametrize("eth,read_len,sat,traceback,field", [
    (13, 150, 32, True, "eth"),             # just past the range
    (-1, 150, 32, True, "eth"),
    (6, 150, 86, True, "sat"),              # past MAX_SAT
    (6, 150, -1, True, "sat"),
    (8, 606, 32, True, "read_len"),         # the traceback's direction words
    (12, 455, 32, True, "read_len"),
    (0, 909, 32, False, "read_len"),        # a block's staged rows
    (6, 150, 32, True, None),
    (0, 908, 32, True, None),
    (12, 150, 85, True, None),
    (6, 558, 32, True, None),
    (6, 559, 32, True, None),               # refused while a byte a cell
    (12, 454, 32, True, None),
    (8, 606, 32, False, None),              # no traceback: the padded engine
    (6, 600, 32, False, None),              # no traceback: the padded engine
])
def test_check_wf_geometry(eth, read_len, sat, traceback, field):
    """The card's early refusal: a ValueError naming the field for what
    the WF kernels do not take, and nothing for what they take."""
    args = (eth, read_len, sat)
    if field is None:
        tops.check_wf_geometry(*args, traceback=traceback)
    else:
        with pytest.raises(ValueError, match=f"^{field}="):
            tops.check_wf_geometry(*args, traceback=traceback)


def test_check_wf_geometry_takes_every_compiled_eth():
    for eth in tops.SUPPORTED_ETH:
        tops.check_wf_geometry(eth, 150, 32)


@pytest.mark.parametrize("fn", sorted(tbuild.ENTRIES))
def test_ctypes_signature_matches_source(fn):
    """The ctypes argument list of each C entry point matches its
    ``extern "C"`` declaration in ``csrc/``: pointers where the source
    takes pointers, and ints, 64-bit ints and floats where it takes them.
    A mismatch would only show as a bad launch on the card."""
    lib, argtypes = tbuild.ENTRIES[fn]
    src = (tbuild.CSRC / tbuild.SOURCES[lib]).read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
    assert m, f"{fn} not declared in {tbuild.SOURCES[lib]}"
    params = [p.strip() for p in m.group(1).split(",")]
    kinds = ["ptr" if "*" in p else p.split()[0] for p in params]
    names = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_int64: "int64_t", ctypes.c_float: "float"}
    assert kinds == [names[t] for t in argtypes], params


@pytest.mark.parametrize("R,n,eth,sat", [
    (17, 24, 6, 32), (32, 40, 4, 16), (21, 30, 8, 32),
    (24, 30, 0, 32), (24, 30, 5, 16), (24, 30, 12, 32),
])
def test_affine_wf_matches_pallas(R, n, eth, sat):
    """The dirs-emitting wrapper: both distances and every direction byte
    against the Pallas kernel of ``affine_wf_pallas``."""
    s1, s2 = _pair_batch(np.random.default_rng(R * 5 + n + eth), R, n, eth)
    want = jops.affine_wf(jnp.array(s1), jnp.array(s2), eth=eth, sat=sat,
                          block_r=32)
    got = tops.affine_wf(_t(s1), _t(s2), eth=eth, sat=sat)
    assert got[2].dtype == torch.uint8
    assert tuple(got[2].shape) == (R, n, 2 * eth + 1)
    _eq([g.numpy() for g in got], want, "affine_wf")


@pytest.mark.parametrize("R,L,k,w,block_r", [
    (8, 150, 12, 30, 8),
    (33, 100, 12, 30, 64),
    (16, 80, 8, 16, 16),
])
def test_minimizer_scan_matches_pallas(R, L, k, w, block_r):
    """Hashes and positions against the Pallas kernel of
    ``minimizer_pallas`` (the shapes of the reference's own sweep)."""
    seqs = np.random.default_rng(R + L + k).integers(0, 4, (R, L)).astype(
        np.uint8)
    mh, mp = jops.minimizer_scan(jnp.array(seqs), k=k, w=w,
                                 block_r=block_r)
    got_h, got_p = tops.minimizer_scan(_t(seqs), k=k, w=w)
    assert got_h.dtype == got_p.dtype == torch.int64
    assert tuple(got_h.shape) == (R, L - (w + k - 1) + 1)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(mh))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(mp))


@pytest.mark.parametrize("R,L,k,w,top", [
    (8, 150, 12, 30, 4),
    (13, 150, 12, 30, 256),     # every byte, SENTINEL included
    (9, 150, 16, 30, 256),      # codes fill 32 bits and wrap
    (7, 150, 12, 1, 4),         # w=1: each k-mer its own window
    (5, 41, 12, 30, 4),         # one window a row
])
def test_minimizer_scan_codes_match_plain(R, L, k, w, top):
    """With ``codes`` the wrapper's first output is the minimizer's k-mer
    code: ``minimizers(...)[1:]`` exactly; without, the hashes."""
    from repro_torch.core.minimizers import minimizers
    seqs = _t(np.random.default_rng(R + L + k + w).integers(
        0, top, (R, L)).astype(np.uint8))
    h, c, p = minimizers(seqs, k=k, w=w)
    _eq(tops.minimizer_scan(seqs, k=k, w=w, codes=True), (c, p), "codes")
    _eq(tops.minimizer_scan(seqs, k=k, w=w), (h, p), "hashes")
    for backend in ("cuda", "torch"):
        _eq(twfb.minimizers(seqs.reshape(1, R, L), k=k, w=w,
                            backend=backend),
            (c.reshape(1, R, -1), p.reshape(1, R, -1)), backend)
    assert tops.LAUNCHES["minimizer_scan"] == 0


@pytest.mark.parametrize("eth", range(13))
def test_minimizer_takes_every_card_read_length(eth):
    """No read length that the card's WF geometry takes
    (``check_wf_geometry``, the padded engine's rule without the
    traceback's, which takes the longest) reaches the minimizer kernel's
    refusal, at the mapper's k and w or the extremes of k and w; nor do
    the index build's rows; and the first length past the minimizer's
    limit is refused naming ``read_len``."""
    from repro_torch.core.index import _SCAN_ROW
    n = 1
    while True:
        try:
            tops.check_wf_geometry(eth, n + 1, 32, traceback=False)
        except ValueError:
            break
        n += 1
    for k, w in ((12, 30), (1, 1), (16, 1), (16, 64)):
        tops.minimizer_layout(n, k, w)
        tops.minimizer_layout(_SCAN_ROW + w + k - 2, k, w)
    top = n
    while True:
        try:
            tops.minimizer_layout(top + 1, 12, 30)
        except ValueError as e:
            assert str(e).startswith("read_len="), e
            break
        top += 1
    assert top > n


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_affine_wf_dirs_leading_dims(backend):
    """``wf_backend.affine_wf_dirs`` takes leading batch dims on both
    backends and gives the reference's planes."""
    s1, s2 = _pair_batch(np.random.default_rng(9), 12, 20, ETH)
    de, dm, dirs = twfb.affine_wf_dirs(_t(s1).reshape(3, 4, 20),
                                       _t(s2).reshape(3, 4, 32), eth=ETH,
                                       sat=SAT, backend=backend)
    assert de.shape == dm.shape == (3, 4)
    assert dirs.shape == (3, 4, 20, 2 * ETH + 1)
    want = jaff.banded_affine(jnp.array(s1), jnp.array(s2), eth=ETH, sat=SAT)
    _eq([de.reshape(-1).numpy(), dm.reshape(-1).numpy(),
         dirs.reshape(12, 20, -1).numpy()], want, "affine_wf_dirs")


def test_new_wrappers_reject_bad_input():
    s1 = torch.zeros((4, 10), dtype=torch.uint8)
    s2 = torch.zeros((4, 22), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tops.affine_wf(s1, s2[:, :-1], eth=ETH)
    with pytest.raises(TypeError):
        tops.affine_wf(s1.to(torch.int8), s2, eth=ETH)
    seqs = torch.zeros((4, 50), dtype=torch.uint8)
    with pytest.raises(ValueError, match="k=17"):
        tops.minimizer_scan(seqs, k=17, w=4)
    with pytest.raises(ValueError, match="shorter than one window"):
        tops.minimizer_scan(seqs, k=12, w=40)
    with pytest.raises(TypeError):
        tops.minimizer_scan(seqs.to(torch.int32), k=12, w=30)
    with pytest.raises(ValueError, match="contiguous"):
        tops.minimizer_scan(torch.zeros((50, 4), dtype=torch.uint8).t(),
                            k=12, w=30)
    assert tops.LAUNCHES["minimizer_scan"] == 0 == tops.LAUNCHES["affine_wf"]
