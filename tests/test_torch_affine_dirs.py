"""The padded affine kernel (``csrc/affine_wf.cu``, ``affine_wf_kernel``) on
the CPU, where it cannot run: a numpy model of its lane arithmetic,
direction bits included, against the plain version ``banded_affine``;
the wrapper's plain route against the reference's Pallas kernel on the
inputs the kernel's design could break; and the view of its padded
direction planes.

The kernel keeps the reference's clamps (its direction bits compare
values that the clamps make equal) but scales every value by 4, so that
the min that gives D also carries dD in its two low bits, M1 and M2
bringing their codes from their own mins; it runs the
column masks only in rows 1..eth and holds two instances a thread in
int16 lanes.  ``_lane_model`` is that arithmetic, one lane an instance,
so these tests pin the algebra the kernel relies on, and show that the
clamps and the masked rows are needed."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.affine_wf import banded_affine
from repro_torch.kernels import ops as tops
from test_torch_affine_dist import _edge_ns, _edge_pairs

LANE = 2 ** 15          # an int16 lane holds values in [-LANE, LANE)


def _lane_model(s1, s2, eth, sat, clamps=True, masks=True, trace=None):
    """``affine_wf_kernel``'s arithmetic (``DirBand`` in csrc/affine_wf.cu),
    one int16 lane an instance, every value scaled by 4: V = 4 D and M = 4
    M1 + 2 carried from row to row, 4 M2 + 3 along the row, the bytes
    scaled by 8.  Per cell: M1 and M2 as three-input mins with sat (4 sat
    + 2, 4 sat + 3), 4 dM1 and 4 dM2 as relu(min(M - V - 6, 4)) and
    relu(min(M2 - V - 7, 4)), the min of 4 D + 5, M and M2 (dD in its low
    bits), min(xor + 4 D, that min) for the match, its code stripped for
    the next row; the column masks in rows 1..eth only.  ``clamps=False``
    drops sat from the two three-input mins; ``masks=False`` runs rows
    1..eth unmasked.  With ``trace`` (a list), appends the largest |value|
    of each row's lanes.  -> (dist_end, dist_min, dirs (R, n, band))."""
    R, n = s1.shape
    band = 2 * eth + 1
    i32 = np.int32
    j0 = np.arange(band) - eth
    row0 = np.where(j0 < 0, sat, np.minimum(np.where(j0 == 0, 0, 1 + j0),
                                            sat))
    V = np.broadcast_to((4 * row0).astype(i32), (R, band)).copy()
    sat4 = np.full(R, 4 * sat, i32)
    M = np.full((R, band), 4 * sat + 2, i32)
    cap = sat4 if clamps else np.full(R, LANE // 2, i32)
    dirs = np.zeros((R, n, band), np.uint8)
    zero = np.zeros(R, i32)
    for i in range(1, n + 1):
        ch = s2[:, i - 1:i - 1 + band].astype(i32) * 8
        c1 = s1[:, i - 1].astype(i32) * 8
        masked = masks and i <= eth
        left = ml = None
        top = 0
        for d in range(band):
            jj = i + d - eth
            m1, f1 = sat4 + 2, zero
            if d + 1 < band:
                m1 = np.minimum(np.minimum(V[:, d + 1] + 10, M[:, d + 1] + 4),
                                cap + 2)
                f1 = np.clip(M[:, d + 1] - V[:, d + 1] - 6, 0, 4)
                if masked and jj < 0:
                    m1 = sat4 + 2
            m2, f2 = sat4 + 3, zero
            if d > 0:
                m2 = np.minimum(np.minimum(left + 11, ml + 4), cap + 3)
                f2 = np.clip(ml - left - 7, 0, 4)
                if masked and jj <= 0:
                    m2 = sat4 + 3
            dmin = np.minimum(np.minimum(V[:, d] + 5, m1), m2)
            x = ch[:, d] ^ c1
            v = np.minimum(x + V[:, d], dmin)
            top = max(top, int(np.abs(x + V[:, d]).max()),
                      int(np.abs(dmin).max()))
            if masked and jj == 0:
                v = m1
            elif masked and jj < 0:
                v = sat4
            dn = v & ~3
            nib = ((v & 3) | f1) + 2 * f2
            if not (masked and jj < 0):
                dirs[:, i - 1, d] = nib
            V[:, d] = left = dn
            M[:, d] = m1
            ml = m2
        if trace is not None:
            trace.append(top)
    return (np.minimum(V[:, eth] >> 2, sat).astype(i32),
            np.minimum(V.min(axis=1) >> 2, sat).astype(i32), dirs)


def _plain(s1, s2, eth, sat):
    return [t.numpy() for t in banded_affine(torch.from_numpy(s1),
                                             torch.from_numpy(s2), eth=eth,
                                             sat=sat)]


@pytest.mark.parametrize("eth", tops.SUPPORTED_ETH)
def test_lane_model_equals_plain_version(eth):
    """The kernel's arithmetic (``_lane_model``) gives ``banded_affine``'s
    distances and every direction byte at every compiled eth: reads of 1,
    eth, eth+1, 2*eth+1 and 37 bases, bases and bytes 0..255 with
    SENTINEL, sat 0, 32 and MAX_SAT; no lane leaves int16."""
    rng = np.random.default_rng(2000 + eth)
    for n in _edge_ns(eth) + [37]:
        s1, s2 = _edge_pairs(rng, 24, n, eth)
        for sat in (0, 32, tops.MAX_SAT):
            trace = []
            got = _lane_model(s1, s2, eth, sat, trace=trace)
            for g, w, what in zip(got, _plain(s1, s2, eth, sat),
                                  ("dist_end", "dist_min", "dirs")):
                np.testing.assert_array_equal(
                    g, w, err_msg=f"{what} n={n} sat={sat}")
            assert max(trace) < LANE


_PALLAS_CASES = [(eth, n, sat) for eth in (0, 6, 12) for n in _edge_ns(eth)
                 for sat in (0, tops.MAX_SAT)]


@pytest.mark.parametrize("eth,n,sat", _PALLAS_CASES,
                         ids=[f"eth{e}-n{n}-sat{s}"
                              for e, n, s in _PALLAS_CASES])
def test_affine_wf_matches_pallas_at_the_edges(eth, n, sat):
    """The wrapper on CPU tensors against ``affine_wf_pallas`` in
    interpret mode on an odd R (a thread's lone low half on the card, the
    plane's padding beside it), reads of 1, eth, eth+1 and 2*eth+1 bases,
    bytes 0..255 and SENTINEL, sat 0 and MAX_SAT: both distances and
    every direction byte."""
    R = 19
    s1, s2 = _edge_pairs(np.random.default_rng(eth * 97 + n * 5 + sat),
                         R, n, eth)
    want = jops.affine_wf(jnp.array(s1), jnp.array(s2), eth=eth, sat=sat,
                          block_r=32)
    got = tops.affine_wf(torch.from_numpy(s1), torch.from_numpy(s2),
                         eth=eth, sat=sat)
    assert got[2].dtype == torch.uint8
    assert tuple(got[2].shape) == (R, n, 2 * eth + 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("what", ["clamps", "masks"])
def test_the_clamps_and_masked_rows_are_needed(what):
    """Why the kernel keeps what its distance twin drops: without the
    clamps to sat, or with rows 1..eth run unmasked, the lane model gives
    other direction bits than the plain version on random reads (the
    clamps leave the distances as they were: only the bits tell)."""
    eth, sat, n = 6, 8, 40
    rng = np.random.default_rng(9)
    s1 = rng.integers(0, 4, (200, n)).astype(np.uint8)
    s2 = rng.integers(0, 4, (200, n + 2 * eth)).astype(np.uint8)
    want = _plain(s1, s2, eth, sat)
    for g, w in zip(_lane_model(s1, s2, eth, sat), want):
        np.testing.assert_array_equal(g, w)
    got = _lane_model(s1, s2, eth, sat, **{what: False})
    assert (got[2] != want[2]).any()
    if what == "clamps":
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("R", [0, 1, 2, 7, tops.DIR_ROWS, tops.DIR_ROWS + 1])
def test_dir_planes_view_leaves_the_padding_out(R):
    """``ops.dir_planes``: the buffer keeps the Pallas kernel's (n * band,
    R) layout with R padded to a multiple of DIR_ROWS, which the (R, n,
    band) view leaves out.  The view is the buffer itself, not a copy:
    byte (r, i, d) is the buffer's (i * band + d, r) (the strides of an
    empty view or a size-1 axis are free)."""
    n, eth = 5, 2
    band = 2 * eth + 1
    planes, dirs = tops.dir_planes(R, n, eth, "cpu")
    Rp = planes.shape[1]
    assert Rp >= R and Rp % tops.DIR_ROWS == 0 and Rp - R < tops.DIR_ROWS
    assert planes.shape[0] == n * band
    assert tuple(dirs.shape) == (R, n, band)
    if R:
        want_strides = (1, band * Rp, Rp)
        assert all(st == w for st, w, size in zip(
            dirs.stride(), want_strides, dirs.shape) if size > 1)
    # written after the view was taken: the view shows it
    planes.copy_(torch.arange(planes.numel()).reshape(planes.shape) % 251)
    want = planes.numpy()[:, :R].T.reshape(R, n, band)
    np.testing.assert_array_equal(dirs.numpy(), want)
    if R:
        assert dirs.data_ptr() == planes.data_ptr()


def test_dir_rows_is_a_block_of_the_kernel():
    """The padding of the planes (``ops.DIR_ROWS``) is the instances of
    one block of ``affine_wf_kernel`` (2 * DIR_THREADS in its source),
    which the kernel's stores rely on and its entry point checks."""
    src = (Path(tops.__file__).parent / "csrc" / "affine_wf.cu").read_text()
    threads = int(re.search(r"constexpr int DIR_THREADS = (\d+);",
                            src).group(1))
    assert tops.DIR_ROWS == 2 * threads
