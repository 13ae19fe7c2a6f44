"""The frozen work counts give ``chip_smoke.py``'s ``bound()`` at equal R."""
import importlib.util
import os

import pytest

from mapbench.counts import wf_bound

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_counts", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["linear_wf", "affine_wf_dist", "affine_wf",
                                  "affine_traceback"])
@pytest.mark.parametrize("R,n,eth", [(1_048_576, 150, 6), (131_072, 150, 6),
                                     (1_002_146, 150, 6), (1000, 37, 0),
                                     (1000, 150, 12)])
def test_bound_equals_chip_smoke(smoke, name, R, n, eth):
    steps = R * (2 * n) if name == "affine_traceback" else 0
    want = smoke.bound(name, R, n, eth, 2 * n + 2, steps)
    got = wf_bound.bound_ms(name, R, n, eth, 2 * n + 2, steps)
    assert got[1] == want[1]
    assert got[0] == pytest.approx(want[0], rel=1e-12)


def test_constants_equal_chip_smoke(smoke):
    assert wf_bound.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S
    assert wf_bound.INT32_OPS_PER_S == smoke.INT32_OPS_PER_S
    assert wf_bound.LIN_PIPE_PER_CELL == smoke.LIN_PIPE_PER_CELL
    assert wf_bound.WALK_OPS_PER_STEP == smoke.WALK_OPS_PER_STEP
    for eth in range(13):
        assert wf_bound.aff_pipe_per_cell(eth) == smoke.aff_pipe_per_cell(eth)
        assert wf_bound.dir_pipe_per_cell(eth) == smoke.dir_pipe_per_cell(eth)


def test_bound_is_linear_in_R():
    a, by_a = wf_bound.bound_ms("affine_wf_dist", 1000, 150, 6)
    b, by_b = wf_bound.bound_ms("affine_wf_dist", 3000, 150, 6)
    assert by_a == by_b and b == pytest.approx(3 * a)
