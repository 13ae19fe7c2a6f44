"""The least time an H100 needs for the mapper's banded Wagner-Fischer work.

A frozen copy of ``bound()`` in the repository's ``chip_smoke.py`` and its
constants, changed in one way: ``R`` is the number of instances that the
inputs need (the valid candidates for the linear filter, the filter's
survivors and the rescue's rows for the affine distance), never the
capacity a program pads its launches to.  The count does not depend on
which kernel runs the work, so a kernel redesigned later is measured
against the same number.

Operations are integer-pipe instructions a band cell on 16x2 DPX lanes
(two instances in the 16-bit halves of a register; Hopper's three-input
and add-fused mins), at the int32 rate of 64 a clock an SM, 132 SMs, 1.98
GHz; bytes are each input byte read once and each output byte written
once, at the 3.35 TB/s of HBM3 (NVIDIA's H100 SXM data sheet).  The time
is the larger of the two.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# the linear recurrence: the mismatch xor, diag + sub as one add-min, the
# three-input min of diag, up + 1 and left + 1, and B + 1 off the pipe, for
# a pair of cells
LIN_PIPE_PER_CELL = 1.5
WALK_OPS_PER_STEP = 16


def aff_pipe_per_cell(eth: int) -> float:
    """Integer-pipe instructions a band cell of the affine recurrence:
    5 a pair of cells inside the band, the band's edges 4 fewer a row (2
    at eth 0)."""
    band = 2 * eth + 1
    per_row = 2 if eth == 0 else 5 * band - 4
    return per_row / (2 * band)


def dir_pipe_per_cell(eth: int) -> float:
    """Integer-pipe instructions a band cell for the direction nibble: 4 a
    pair of cells (3 a row at eth 0)."""
    band = 2 * eth + 1
    per_row = 3 if eth == 0 else 4 * band
    return per_row / (2 * band)


def bound_ms(name: str, R: int, n: int, eth: int, max_ops: int = 0,
             steps: int = 0) -> tuple[float, str]:
    """(least milliseconds, "operations" or "bytes") for ``R`` instances of
    kernel ``name`` on reads of ``n`` bases; ``steps``: the traceback's
    walk lengths summed."""
    cells = R * n * (2 * eth + 1)
    n_bytes = R * (2 * n + 2 * eth + 8)
    aff = aff_pipe_per_cell(eth)
    dirs = dir_pipe_per_cell(eth)
    if name == "linear_wf":
        n_ops = LIN_PIPE_PER_CELL * cells
    elif name == "affine_wf_dist":
        n_ops = aff * cells
    elif name == "affine_wf":
        n_ops = (aff + dirs) * cells
        n_bytes += cells
    elif name == "affine_traceback":
        n_ops = (aff + dirs) * cells + WALK_OPS_PER_STEP * steps
        n_bytes += R * (4 * max_ops + 4)
    else:
        raise ValueError(f"no count for kernel {name!r}")
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
