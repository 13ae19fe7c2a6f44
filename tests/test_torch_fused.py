"""The port's fused engine against the reference's, over the same cases as
``test_torch_mapper.py`` (kept in its own file so the two run side by
side under the parallel test runner)."""
import pytest

from test_torch_mapper import CASES, assert_same, map_both, world  # noqa: F401


@pytest.mark.parametrize("both_strands,cigar_mode,chunk,stream", CASES)
def test_fused_engine_matches_reference(world, both_strands, cigar_mode,
                                        chunk, stream):
    got, want = map_both(world, engine="fused", both_strands=both_strands,
                         cigar_mode=cigar_mode, chunk_reads=chunk,
                         stream=stream)
    assert got.linear_dist is None
    assert_same(got, want)
