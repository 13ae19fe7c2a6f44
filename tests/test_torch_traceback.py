"""The fused affine + traceback wrapper (``repro_torch.kernels.ops
.affine_traceback``) at the edges its Hopper kernel must take, on CPU
tensors (its plain version) against the reference's Pallas kernel in
interpret mode, and the card's geometry rule for that kernel.  Integer
outputs: equality is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

SAT = 32
SMEM = 232_448  # a Hopper block's shared memory


def _near_pairs(rng, R, n, eth):
    """Reads and windows of bytes 0..255: the first half are the read
    embedded in its window with up to three substitutions, the rest
    random."""
    s1 = rng.integers(0, 256, (R, n)).astype(np.uint8)
    s2 = rng.integers(0, 256, (R, n + 2 * eth)).astype(np.uint8)
    s2[: R // 2, eth : eth + n] = s1[: R // 2]
    for r in range(R // 2):
        for _ in range(int(rng.integers(0, 4))):
            s2[r, eth + int(rng.integers(0, n))] = rng.integers(0, 256)
    return s1, s2


# reads no longer than the band and just past it (every row's band
# reaching left of column 0, all but the last's), at the ends and the
# middle of the compiled eth range, with op rows shorter than any walk,
# shorter than most, and long enough for all
_EDGES = [(eth, n, max_ops) for eth in (0, 5, 12)
          for n in sorted({1, eth, eth + 1, 2 * eth + 1} - {0})
          for max_ops in (1, 3, 2 * n + 2)]


@pytest.mark.parametrize("eth,n,max_ops", _EDGES,
                         ids=[f"eth{e}-n{n}-ops{m}" for e, n, m in _EDGES])
def test_affine_traceback_edges_match_pallas(eth, n, max_ops):
    s1, s2 = _near_pairs(np.random.default_rng(100 * eth + n), 24, n, eth)
    want = jops.affine_traceback(jnp.array(s1), jnp.array(s2), eth=eth,
                                 sat=SAT, max_ops=max_ops, block_r=8)
    got = tops.affine_traceback(torch.from_numpy(s1), torch.from_numpy(s2),
                                eth=eth, sat=SAT, max_ops=max_ops)
    for g, w, name in zip(got, want, ("dist_end", "dist_min", "ops",
                                      "op_count")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{name} eth={eth} n={n} "
                                              f"max_ops={max_ops}")


def _taken_before(eth):
    """The longest read the card took at ``eth`` before the directions
    were packed: 128 staged reads and windows, and one direction byte a
    band cell for 32 instances, in a block's shared memory."""
    return min(SMEM // 128 // 2 - eth, SMEM // (32 * (2 * eth + 1)))


def _taken_now(eth):
    """The longest read the card takes at ``eth``: the staged rows as
    before, and for 32 instances one 32-bit word a row per 8 band
    cells."""
    words = -(-(2 * eth + 1) // 8)
    return min(SMEM // 128 // 2 - eth, SMEM // (32 * 4 * words))


@pytest.mark.parametrize("eth", tops.SUPPORTED_ETH)
def test_traceback_geometry_keeps_what_the_card_took(eth):
    """Every read length the card took at ``eth`` it still takes; the
    first one past the new limit is refused before any work, naming
    ``read_len``, and, where the traceback's directions are what limit
    it, taken by the engines that do not run the traceback."""
    assert _taken_now(eth) >= _taken_before(eth)
    for n in range(1, _taken_now(eth) + 1):
        tops.check_wf_geometry(eth, n, SAT)
    past = _taken_now(eth) + 1
    with pytest.raises(ValueError, match="^read_len="):
        tops.check_wf_geometry(eth, past, SAT)
    if past <= SMEM // 128 // 2 - eth:
        tops.check_wf_geometry(eth, past, SAT, traceback=False)
        with pytest.raises(ValueError, match="^read_len="):
            tops.traceback_threads(past, eth)


@pytest.mark.parametrize("n,eth,threads", [
    (150, 6, 128),    # the main path: one block of 128 an SM
    (150, 12, 64),
    (227, 6, 128),    # the longest read a block of 128 takes at eth 6
    (228, 6, 64),
    (902, 6, 32),     # the longest at eth 6, where the staged rows bind
    (454, 12, 32),    # the longest at eth 12, where the directions bind
])
def test_traceback_threads(n, eth, threads):
    """The most of 128, 64 and 32 instances whose directions fit a
    block."""
    assert tops.traceback_threads(n, eth) == threads
    assert tops.traceback_smem(n, eth, threads) <= SMEM
