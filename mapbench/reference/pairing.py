"""The plain reference of paired-end resolution: FR proper pairs, mate
rescue and MAPQ, as the mapper's paired path defines them.

  * Insert window: each batch observes the fragment lengths of its pairs
    that face each other (both mapped, opposite strands, the forward mate
    not downstream of the reverse one; length = reverse start + read_len
    - forward start), keeps the last 4,096, and takes median +- max(8 x
    1.4826 x MAD, median / 4, 16); below 32 observations it accepts 0 ..
    10,000, and below 4 it does not rescue.
  * Rescue: a pair with one mate mapped slides the other mate (reverse
    complemented where its anchor is forward) over the starts the window
    allows (stride 1, coarsened to at most 512 starts, only starts where
    the read lies inside the reference), takes the least affine distance
    and then the least start, and places it if that distance is within
    eth; the placed mate's runner-up is its own distance.
  * MAPQ: 6 x (runner-up - distance, within 0..sat) - distance, within
    0..60; +8 (to 60) for proper pairs, halved for discordant ones (both
    mapped, not proper), 0 unmapped; a rescued mate is capped at 17 and at
    its anchor's score.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dp
from .mapper import SENTINEL, Geometry

KEEP_INSERTS = 4096
MIN_PROPER_SAMPLES = 32
MIN_RESCUE_SAMPLES = 4
OPEN_WINDOW = (0, 10_000)
MAX_STARTS = 512


def fr_geometry(pos1, s1, pos2, s2, read_len: int):
    """(facing, insert) of each pair from both mates' starts and strands."""
    pos1, pos2 = np.asarray(pos1, np.int64), np.asarray(pos2, np.int64)
    fwd = np.where(s1 == 0, pos1, pos2)
    rev = np.where(s1 == 0, pos2, pos1)
    return (s1 != s2) & (fwd <= rev), (rev + read_len - fwd).astype(np.int32)


def insert_windows(pos1, s1, m1, pos2, s2, m2, read_len: int):
    """(proper window, rescue window or None) of one batch."""
    facing, insert = fr_geometry(pos1, s1, pos2, s2, read_len)
    seen = insert[facing & m1 & m2][-KEEP_INSERTS:].astype(np.float64)

    def mad_window():
        med = float(np.median(seen))
        mad = float(np.median(np.abs(seen - med)))
        half = max(8.0 * 1.4826 * mad, 0.25 * med, 16.0)
        return max(int(med - half), 0), int(med + half)

    proper = mad_window() if len(seen) >= MIN_PROPER_SAMPLES else OPEN_WINDOW
    rescue = mad_window() if len(seen) >= MIN_RESCUE_SAMPLES else None
    return proper, rescue


def rescue_starts(anchor_pos: int, anchor_strand: int, window, read_len: int,
                  genome_len: int) -> np.ndarray:
    """The starts a rescue tries for the mate of an anchor."""
    lo_ins, hi_ins = window
    if anchor_strand == 0:
        lo, hi = anchor_pos + lo_ins - read_len, anchor_pos + hi_ins - read_len
    else:
        lo, hi = anchor_pos + read_len - hi_ins, anchor_pos + read_len - lo_ins
    step = max(1, -(-(hi - lo + 1) // MAX_STARTS))
    s = np.arange(lo, hi + 1, step, dtype=np.int64)
    return s[(s >= 0) & (s <= genome_len - read_len)][:MAX_STARTS]


def rescue(ref: torch.Tensor, g: Geometry, reads: np.ndarray,
           anchor_pos, anchor_strand, windows):
    """Rescue sweeps of several mates at once: the mates ``reads`` (as
    sequenced) of anchors at ``anchor_pos`` on ``anchor_strand``, each
    under its batch's rescue window (``windows`` (n, 2)).  Returns per mate
    (placed, start, distance, strand) arrays and the rows swept."""
    n = len(reads)
    strand = (1 - np.asarray(anchor_strand)).astype(np.int8)
    placed = np.zeros(n, bool)
    start = np.full(n, -1, np.int64)
    dist = np.full(n, g.sat, np.int32)
    starts = [rescue_starts(int(anchor_pos[i]), int(anchor_strand[i]),
                            tuple(windows[i]), g.read_len, ref.shape[0])
              for i in range(n)]
    owner = np.concatenate([np.full(len(s), i) for i, s in enumerate(starts)]
                           + [np.zeros(0, np.int64)]).astype(np.int64)
    starts = np.concatenate(starts + [np.zeros(0, np.int64)])
    if not len(starts):
        return placed, start, dist, strand, 0
    dev = ref.device
    a = torch.as_tensor(np.asarray(reads, np.uint8), device=dev)
    flip = torch.as_tensor(strand == 1, device=dev)
    a = torch.where(flip[:, None], (3 - a).flip(-1), a)
    st = torch.as_tensor(starts, device=dev)
    col = st[:, None] - g.eth + torch.arange(g.read_len + 2 * g.eth,
                                            device=dev)
    G = ref.shape[0]
    win = torch.where((col >= 0) & (col < G), ref[torch.clamp(col, 0, G - 1)],
                      SENTINEL).to(torch.uint8)
    d, _ = dp.affine(a[torch.as_tensor(owner, device=dev)], win, g.eth,
                     g.sat, want_dirs=False)
    d = d.cpu().numpy()
    for i in range(n):
        mine = (owner == i) & (d <= g.eth)
        if mine.any():
            best = np.lexsort((starts[mine], d[mine]))[0]
            placed[i] = True
            start[i] = starts[mine][best]
            dist[i] = d[mine][best]
    return placed, start, dist, strand, len(starts)


def mapq(distance, distance2, mapped, sat: int, proper, mate_mapped):
    d1 = np.asarray(distance, np.int64)
    d2 = np.asarray(distance2, np.int64)
    q = np.clip(6 * np.clip(d2 - d1, 0, sat) - d1, 0, 60)
    q = np.where(proper, np.minimum(q + 8, 60), q)
    q = np.where(~proper & mate_mapped, q // 2, q)
    return np.where(mapped, q, 0).astype(np.int32)


def resolve(ref: torch.Tensor, g: Geometry, mate1: dict, mate2: dict,
            reads1: np.ndarray, reads2: np.ndarray, windows: list) -> dict:
    """Resolve pairs whose mates' mapping fields (position, strand,
    distance, distance2, mapped) are in ``mate1``/``mate2``, each pair
    under its batch's ``windows`` (``insert_windows``; one entry a pair).
    Returns per pair: proper, insert, mapq1, mapq2, rescued1, rescued2 and
    each mate's fields after rescue as ``<field>_1`` and ``<field>_2``,
    plus ``rescue_rows``."""
    m = [dict((k, np.array(v, copy=True)) for k, v in x.items())
         for x in (mate1, mate2)]
    reads = (reads1, reads2)
    n = len(m[0]["position"])
    proper_win = np.array([w[0] for w in windows], np.int64).reshape(n, 2)
    can = np.array([w[1] is not None for w in windows], bool)
    rescue_win = np.array([w[1] if w[1] is not None else (0, 0)
                           for w in windows], np.int64).reshape(n, 2)
    rescued = [np.zeros(n, bool), np.zeros(n, bool)]
    rows = 0
    if can.any():
        for lost, anchor in ((1, 0), (0, 1)):
            only = np.flatnonzero(m[anchor]["mapped"] & ~m[lost]["mapped"]
                                  & can)
            ok, s, d, strand, swept = rescue(
                ref, g, np.asarray(reads[lost])[only],
                m[anchor]["position"][only], m[anchor]["strand"][only],
                rescue_win[only])
            rows += swept
            i = only[ok]
            x = m[lost]
            x["position"][i], x["distance"][i] = s[ok], d[ok]
            x["distance2"][i], x["mapped"][i] = d[ok], True
            x["strand"][i] = strand[ok]
            rescued[lost][i] = True
    m1, m2 = m[0]["mapped"], m[1]["mapped"]
    facing, insert = fr_geometry(m[0]["position"], m[0]["strand"],
                                 m[1]["position"], m[1]["strand"], g.read_len)
    facing &= m1 & m2
    proper = facing & (insert >= proper_win[:, 0]) & (insert <= proper_win[:, 1])
    q1 = mapq(m[0]["distance"], m[0]["distance2"], m1, g.sat, proper, m2)
    q2 = mapq(m[1]["distance"], m[1]["distance2"], m2, g.sat, proper, m1)
    q2 = np.where(rescued[1], np.minimum(np.minimum(q1, 17), q2), q2)
    q1 = np.where(rescued[0], np.minimum(np.minimum(q2, 17), q1), q1)
    out = dict(proper=proper, insert=np.where(facing, insert, 0).astype(
        np.int32), mapq1=q1, mapq2=q2, rescued1=rescued[0],
        rescued2=rescued[1], rescue_rows=rows)
    for t, x in ((1, m[0]), (2, m[1])):
        for k, v in x.items():
            out[f"{k}_{t}"] = v
    return out
