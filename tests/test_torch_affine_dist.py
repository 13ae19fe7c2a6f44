"""The affine distance kernel (``csrc/affine_wf.cu``, ``affine_dist_kernel``)
on the CPU, where it cannot run: its wrapper's plain version against the
reference's Pallas kernel on the inputs the kernel's design could break,
and a numpy model of the kernel's arithmetic against the plain version.

The kernel drops the reference's clamps (to ``sat`` after every step),
its column masks (rows 1..eth) and its match select (a match takes the
diagonal without a min); it holds two instances a thread in int16
lanes.  ``_kernel_model`` is that arithmetic, lane for lane, so these
tests pin the algebra that lets the kernel drop them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.affine_wf import banded_affine_dist
from repro_torch.core.encoding import SENTINEL
from repro_torch.kernels import ops as tops

I16 = np.int16


def _kernel_model(s1, s2, eth, sat, trace=None, select=False):
    """``affine_dist_kernel``'s arithmetic on int16 lanes, one lane an
    instance: D and F = M1 + 1 carried from row to row, M2 + 1 along the
    row, no clamp until the outputs, no column mask, min(diagonal, M1,
    M2) on every cell, the edge cells' off-band operands left out.  With
    ``trace`` (a list), appends the largest value of each row's lanes.
    ``select``: a match takes the diagonal without the min, as the
    reference does (not the kernel).  -> (dist_end, dist_min) int32."""
    R, n = s1.shape
    band = 2 * eth + 1
    j0 = np.arange(band) - eth
    row0 = np.where(j0 < 0, sat, np.minimum(np.where(j0 == 0, 0, 1 + j0),
                                            sat))
    D = np.broadcast_to(row0.astype(I16), (R, band)).copy()
    F = np.full((R, band), sat + 1, I16)
    one, two = I16(1), I16(2)
    for i in range(1, n + 1):
        ch = s2[:, i - 1:i - 1 + band].astype(I16)
        c1 = s1[:, i - 1].astype(I16)
        Dn, Fn = np.empty_like(D), np.empty_like(F)
        left = g = None
        top = 0
        for d in range(band):
            # D + (bytes differ): min(xor + D, D + 1), xor in 0..255
            x_d = (ch[:, d] ^ c1) + D[:, d]
            v = np.minimum(x_d, D[:, d] + one)
            top = max(top, int(x_d.max()))
            if d + 1 < band:            # M1 = min(D_up + 2, M1_up + 1)
                m1 = D[:, d + 1] + two
                if d + 2 < band:
                    m1 = np.minimum(m1, F[:, d + 1])
                Fn[:, d] = m1 + one
                v = np.minimum(v, m1)
                top = max(top, int(Fn[:, d].max()))
            if d > 0:                   # M2 = min(D_left + 2, M2_left + 1)
                m2 = left + two if g is None else np.minimum(left + two, g)
                g = m2 + one
                v = np.minimum(v, m2)
                top = max(top, int(g.max()))
            if select:
                v = np.where(ch[:, d] == c1, D[:, d], v)
            Dn[:, d] = left = v
        D, F = Dn, Fn
        if trace is not None:
            trace.append(max(top, int(D.max())))
    s = I16(sat)
    return (np.minimum(D[:, eth], s).astype(np.int32),
            np.minimum(D.min(axis=1), s).astype(np.int32))


def _edge_pairs(rng, R, n, eth):
    """Near-match pairs (the read in its window, a few bytes changed, some
    inserted or deleted: gaps at the band's edges), half of them of bases
    0..3 and half of bytes 0..255 with SENTINEL; then one tenth of all
    bytes set to SENTINEL."""
    s1 = np.empty((R, n), np.uint8)
    s2 = np.empty((R, n + 2 * eth), np.uint8)
    for r in range(R):
        top = 4 if r % 2 == 0 else 256
        a = rng.integers(0, top, n)
        w = list(np.concatenate([rng.integers(0, top, eth), a,
                                 rng.integers(0, top, eth)]))
        for _ in range(int(rng.integers(0, 2 * eth + 3))):
            kind, p = int(rng.integers(0, 3)), int(rng.integers(0, len(w)))
            if kind == 0:
                w[p] = int(rng.integers(0, top))
            elif kind == 1:
                w.insert(p, int(rng.integers(0, top)))
            elif len(w) > 1:
                del w[p]
        s1[r] = a
        s2[r] = (w + [0] * (n + 2 * eth))[:n + 2 * eth]
    for s in (s1, s2):
        s[rng.random(s.shape) < 0.1] = SENTINEL
    return s1, s2


def _edge_ns(eth):
    """Reads no longer than the band and just past it: every row's band
    reaching left of column 0, all but the last's, and rows past them."""
    return sorted({1, eth, eth + 1, 2 * eth + 1} - {0})


_PALLAS_CASES = [(eth, n, sat) for eth in (0, 6, 12) for n in _edge_ns(eth)
                 for sat in (0, tops.MAX_SAT)]


@pytest.mark.parametrize("eth,n,sat", _PALLAS_CASES,
                         ids=[f"eth{e}-n{n}-sat{s}"
                              for e, n, s in _PALLAS_CASES])
def test_affine_wf_dist_matches_pallas_at_the_edges(eth, n, sat):
    """The wrapper on CPU tensors against ``affine_wf_dist_pallas`` on an
    odd R (a pair's lone low half, the high half empty, on the card),
    reads of 1, eth, eth+1 and 2*eth+1 bases, bytes 0..255 and SENTINEL,
    sat 0 and MAX_SAT."""
    R = 19
    s1, s2 = _edge_pairs(np.random.default_rng(eth * 131 + n * 7 + sat),
                         R, n, eth)
    want = jops.affine_wf_dist(jnp.array(s1), jnp.array(s2), eth=eth,
                               sat=sat, block_r=32)
    got = tops.affine_wf_dist(torch.from_numpy(s1), torch.from_numpy(s2),
                              eth=eth, sat=sat)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("eth", tops.SUPPORTED_ETH)
def test_kernel_arithmetic_equals_plain_version(eth):
    """The kernel's arithmetic (``_kernel_model``) equals
    ``banded_affine_dist`` at every compiled eth: reads of 1, eth, eth+1,
    2*eth+1 and 37 bases, near-match pairs with gaps at the band's edges,
    bases and bytes 0..255, sat 0, 32 and MAX_SAT."""
    rng = np.random.default_rng(1000 + eth)
    for n in _edge_ns(eth) + [37]:
        s1, s2 = _edge_pairs(rng, 24, n, eth)
        for sat in (0, 32, tops.MAX_SAT):
            want = banded_affine_dist(torch.from_numpy(s1),
                                      torch.from_numpy(s2), eth=eth, sat=sat)
            got = _kernel_model(s1, s2, eth, sat)
            for g, w, what in zip(got, want, ("dist_end", "dist_min")):
                np.testing.assert_array_equal(
                    g, w.numpy(), err_msg=f"{what} n={n} sat={sat}")


def test_the_min_keeps_column_zero_without_masks():
    """Why the kernel takes the min on a match: without the column masks,
    the reference's select would take the diagonal of column 0 in rows
    1..eth, which comes from left of column 0 (>= sat), where the
    reference takes M1 even on a match; the min takes M1 there.  On
    random bases some reads show it."""
    eth, sat, n = 6, 32, 13
    rng = np.random.default_rng(5)
    s1 = rng.integers(0, 4, (500, n)).astype(np.uint8)
    s2 = rng.integers(0, 4, (500, n + 2 * eth)).astype(np.uint8)
    want = [w.numpy() for w in banded_affine_dist(
        torch.from_numpy(s1), torch.from_numpy(s2), eth=eth, sat=sat)]
    for g, w in zip(_kernel_model(s1, s2, eth, sat), want):
        np.testing.assert_array_equal(g, w)
    unmasked_select = _kernel_model(s1, s2, eth, sat, select=True)
    assert any((u != w).any() for u, w in zip(unmasked_select, want))


@pytest.mark.parametrize("eth", [0, 6, 12])
def test_lanes_stay_below_2_to_15_at_the_longest_read(eth):
    """At the longest read ``check_wf_geometry`` takes (the next one is
    refused), sat = MAX_SAT and every byte a mismatch, the largest value
    a 16-bit lane reaches (the add-min's xor + D included) stays within
    the kernel's stated bound 255 + sat + n, far below 2^15."""
    n = _longest_read(eth)
    tops.check_wf_geometry(eth, n, tops.MAX_SAT, traceback=False)
    with pytest.raises(ValueError, match="^read_len="):
        tops.check_wf_geometry(eth, n + 1, tops.MAX_SAT, traceback=False)
    s1 = np.zeros((2, n), np.uint8)
    s2 = np.full((2, n + 2 * eth), 255, np.uint8)
    s1[1] = np.arange(n) % 256
    trace = []
    de, dm = _kernel_model(s1, s2, eth, tops.MAX_SAT, trace)
    assert (de == tops.MAX_SAT).all() and (dm == tops.MAX_SAT).all()
    assert max(trace) <= 255 + tops.MAX_SAT + n < 2 ** 15
    assert trace[-1] >= n                       # the values did grow


def _longest_read(eth):
    """The longest read ``check_wf_geometry`` takes at ``eth`` for the
    distance kernels (no traceback)."""
    n = 1
    while True:
        try:
            tops.check_wf_geometry(eth, n + 1, tops.MAX_SAT, traceback=False)
        except ValueError:
            return n
        n += 1
