"""The instances of work that a window's inputs need, counted from what the
program returned and the benchmark's own arithmetic.

  * linear filter: every valid candidate of every read encoding
    (``MappingResult.stats`` ``candidates``);
  * affine distance: every filter survivor (``stats`` ``survivors``) plus,
    on the paired path, every rescue row: the starts that the insert
    window allows for each mate whose partner alone mapped
    (``reference.pairing.rescue_starts`` under the batch's window).
"""
from __future__ import annotations

import numpy as np

from mapbench.reference.pairing import insert_windows, rescue_starts


def rescue_rows(pre: dict, read_len: int, genome_len: int) -> int:
    """Rescue rows of one paired batch, from its mates' mapping before
    resolution: ``pre`` holds pos1, s1, m1, pos2, s2, m2 (whole batch)."""
    _, window = insert_windows(pre["pos1"], pre["s1"], pre["m1"],
                               pre["pos2"], pre["s2"], pre["m2"], read_len)
    if window is None:
        return 0
    rows = 0
    for anchor, lost in (("1", "2"), ("2", "1")):
        only = np.flatnonzero(pre["m" + anchor] & ~pre["m" + lost])
        for i in only:
            rows += len(rescue_starts(int(pre["pos" + anchor][i]),
                                      int(pre["s" + anchor][i]), window,
                                      read_len, genome_len))
    return rows
