"""The plain reference of the mapper that the benchmark judges: DART-PIM's
read mapping (arXiv:2411.03832, Secs. V-B to V-E) written out in plain
PyTorch, with nothing taken from the program.

  1. Index: every window of ``w`` consecutive k-mers of the reference is
     represented by its minimizer, the k-mer of least 32-bit hash (ties to
     the leftmost); the distinct minimizer positions, grouped by k-mer
     code, in ascending position.
  2. Seeding: a read's window minimizers; its distinct codes, the
     ``max_minis`` smallest kept, each at the read offset of its first
     window; each code's first ``max_pls`` reference occurrences are its
     candidates, the read placed at occurrence - offset.
  3. Linear filter: the banded edit distance of every candidate; per
     minimizer the candidate of least distance (first on ties) goes on if
     that distance is within ``filter_threshold``.
  4. Affine: the banded affine distance of each minimizer's survivor; the
     read's best is the least distance, on ties the least position, then
     the first minimizer; it maps if that distance is under ``sat``.
  5. Runner-up (``distance2``): the least affine distance of a survivor
     more than ``eth`` from the winner, else ``sat``; lowered to the
     winner's distance plus the excess linear distance of any candidate
     more than ``eth`` away whose linear distance is within the filter.
  6. Both strands: the read and its reverse complement are mapped; the
     reverse wins only on a strictly lower distance; the runner-up is the
     lesser of the winner's runner-up and the loser's distance.
  7. Traceback: the winner's alignment walked back into CIGAR ops.

Everything runs on whatever device the inputs are on, in batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import dp

M32 = 0xFFFFFFFF
SENTINEL = 4            # a base that matches nothing, past the reference's ends
POS_NONE = torch.iinfo(torch.int64).max


@dataclasses.dataclass(frozen=True)
class Geometry:
    read_len: int
    k: int
    w: int
    eth: int
    sat: int
    max_minis: int
    max_pls: int
    filter_threshold: int
    max_ops: int

    @classmethod
    def of(cls, mapper: dict, **change) -> "Geometry":
        g = dict(read_len=mapper["read_len"], k=mapper["k"], w=mapper["w"],
                 eth=mapper["eth"], sat=mapper["sat_affine"],
                 max_minis=mapper["max_minis"], max_pls=mapper["max_pls"],
                 filter_threshold=mapper["filter_threshold"],
                 max_ops=2 * mapper["read_len"] + 2)
        g.update(change)
        return cls(**g)


def kmer_codes(seq: torch.Tensor, k: int) -> torch.Tensor:
    """2-bit big-endian codes of every k-mer along the last axis, int64
    holding 32 bits (a base of 4 spills into its neighbour's bits)."""
    n = seq.shape[-1] - k + 1
    s = seq.to(torch.int64)
    code = torch.zeros(seq.shape[:-1] + (n,), dtype=torch.int64,
                       device=seq.device)
    for t in range(k):
        code = (code << 2) | s[..., t : t + n]
    return code & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit integer hash that orders k-mers (xor-shift / multiply)."""
    x = x & M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & M32
    return x ^ (x >> 16)


def window_minimizers(seq: torch.Tensor, k: int, w: int):
    """Per window of ``w`` k-mers: (code, position) of the k-mer of least
    hash, the leftmost on ties.  The least over a window is built from
    the least over halves: spans of 1, 2, 4, ... k-mers, then one last
    overlapping step to reach ``w``."""
    code = kmer_codes(seq, k)
    h = mix32(code)
    pos = torch.arange(code.shape[-1], device=seq.device).expand(code.shape)
    span = 1
    while span < w:
        s = min(span, w - span)
        ha, pa = h[..., :-s], pos[..., :-s]
        hb, pb = h[..., s:], pos[..., s:]
        right = (hb < ha) | ((hb == ha) & (pb < pa))
        h = torch.where(right, hb, ha)
        pos = torch.where(right, pb, pa)
        span += s
    n_win = seq.shape[-1] - (w + k - 1) + 1
    pos = pos[..., :n_win]
    return code.gather(-1, pos), pos


class Index:
    """Minimizer occurrences of a reference, built from its bases."""

    def __init__(self, ref: torch.Tensor, g: Geometry, tile: int = 1 << 24):
        self.ref = ref
        self.g = g
        span = g.w + g.k - 1
        n_win = ref.shape[0] - span + 1
        codes, poss = [], []
        for a in range(0, n_win, tile):
            b = min(a + tile, n_win)
            c, p = window_minimizers(ref[a : b + span - 1], g.k, g.w)
            codes.append(c)
            poss.append(p + a)
        code, pos = torch.cat(codes), torch.cat(poss)
        # a window's minimizer never lies left of the previous window's, so
        # each position's repeats are neighbours
        first = torch.ones_like(pos, dtype=torch.bool)
        first[1:] = pos[1:] != pos[:-1]
        code, pos = code[first], pos[first]
        order = torch.sort(code, stable=True).indices
        self.codes = code[order]
        self.pos = pos[order]

    def with_geometry(self, g: Geometry) -> "Index":
        """The same occurrences under another geometry of equal k, w and
        read length (the control's saturation)."""
        other = object.__new__(Index)
        other.ref, other.g = self.ref, g
        other.codes, other.pos = self.codes, self.pos
        return other

    def lookup(self, codes: torch.Tensor, valid: torch.Tensor):
        """The first ``max_pls`` occurrence positions of each code:
        (positions (..., P) int64, valid (..., P) bool).  A lane with no
        occurrence holds the index's first entry, as the mapper's row 0."""
        P = self.g.max_pls
        lo = torch.searchsorted(self.codes, codes, right=False)
        hi = torch.searchsorted(self.codes, codes, right=True)
        lanes = torch.arange(P, device=codes.device)
        ok = (lanes < (hi - lo)[..., None]) & valid[..., None]
        row = torch.clamp(lo[..., None] + lanes, max=self.codes.shape[0] - 1)
        return torch.where(ok, self.pos[row], self.pos[0]), ok

    def windows(self, start: torch.Tensor) -> torch.Tensor:
        """Reference bases ``start - eth .. start + read_len + eth - 1`` of
        each placement, SENTINEL outside the reference."""
        g = self.g
        width = g.read_len + 2 * g.eth
        col = start[..., None] - g.eth + torch.arange(width,
                                                      device=start.device)
        G = self.ref.shape[0]
        inside = (col >= 0) & (col < G)
        return torch.where(inside, self.ref[torch.clamp(col, 0, G - 1)],
                           SENTINEL).to(torch.uint8)


def read_minimizers(reads: torch.Tensor, g: Geometry):
    """A read's distinct minimizer codes, ascending, the ``max_minis``
    smallest, each at the read offset of the first window it represents:
    (codes (R, M), offsets (R, M), valid (R, M))."""
    code, pos = window_minimizers(reads, g.k, g.w)
    code, pos = code.cpu().numpy(), pos.cpu().numpy()
    R = code.shape[0]
    M = g.max_minis
    out_c = np.zeros((R, M), dtype=np.int64)
    out_p = np.zeros((R, M), dtype=np.int64)
    valid = np.zeros((R, M), dtype=bool)
    for r in range(R):
        keys, first = np.unique(code[r], return_index=True)
        keys, first = keys[:M], first[:M]
        out_c[r, : len(keys)] = keys
        out_p[r, : len(keys)] = pos[r, first]
        valid[r, : len(keys)] = True
    dev = reads.device
    return (torch.from_numpy(out_c).to(dev), torch.from_numpy(out_p).to(dev),
            torch.from_numpy(valid).to(dev))


def _map_one_strand(idx: Index, reads: torch.Tensor):
    """Steps 2 to 5 for one encoding of each read: per read the winner's
    (distance, position, runner-up, mapped, candidate count, linear
    distances (M, P), winning placement's start) and the candidates."""
    g = idx.g
    R = reads.shape[0]
    M, P = g.max_minis, g.max_pls
    cap_lin = g.eth + 1
    dev = reads.device
    codes, off, mvalid = read_minimizers(reads, g)
    occ, ok = idx.lookup(codes, mvalid)                      # (R, M, P)
    start = occ - off[..., None]                              # placements
    # linear distance of every candidate
    lin = torch.full((R, M, P), cap_lin, dtype=torch.int32, device=dev)
    r_i, m_i, p_i = torch.nonzero(ok, as_tuple=True)
    if len(r_i):
        lin[r_i, m_i, p_i] = dp.linear_distance(
            reads[r_i], idx.windows(start[r_i, m_i, p_i]), g.eth)
    best_p = torch.argmin(lin, dim=-1)                        # first minimum
    best_lin = lin.gather(-1, best_p[..., None])[..., 0]
    passed = best_lin <= g.filter_threshold                  # (R, M)
    surv_start = start.gather(-1, best_p[..., None])[..., 0]
    surv_occ_ok = ok.gather(-1, best_p[..., None])[..., 0]
    # affine distance of each minimizer's survivor
    aff = torch.full((R, M), g.sat, dtype=torch.int32, device=dev)
    r_s, m_s = torch.nonzero(passed, as_tuple=True)
    if len(r_s):
        aff[r_s, m_s], _ = dp.affine(reads[r_s],
                                     idx.windows(surv_start[r_s, m_s]),
                                     g.eth, g.sat, want_dirs=False)
    # a survivor is a placement only where it starts inside the reference
    # (a survivor always lies on a valid occurrence: invalid ones sit at
    # the cap, above the threshold)
    placed = surv_start >= 0
    best = aff.amin(dim=-1)
    mapped = best < g.sat
    key = torch.where((aff == best[:, None]) & placed, surv_start, POS_NONE)
    position = key.amin(dim=-1)
    m_ar = torch.arange(M, device=dev)
    win_m = torch.where(key == position[:, None], m_ar, M).argmin(dim=-1)
    position = torch.where(mapped & (position < POS_NONE), position, -1)
    # runner-up among survivors
    far = (surv_start - position[:, None]).abs() > g.eth
    second = torch.where((aff < g.sat) & far & placed, aff, g.sat).amin(
        dim=-1)
    # runner-up among filtered candidates far from the winner
    far_all = (start - position[:, None, None]).abs() > g.eth
    near_best = ok & far_all & (lin <= min(g.filter_threshold, g.eth))
    lin_far = torch.where(near_best, lin, cap_lin).amin(dim=(1, 2))
    lin_win = lin.amin(dim=-1).gather(1, win_m[:, None])[:, 0]
    est = torch.clamp(best + torch.clamp(lin_far - lin_win, min=0),
                      max=g.sat)
    second = torch.where(lin_far < cap_lin, torch.minimum(second, est),
                         second)
    r_ar = torch.arange(R, device=dev)
    return dict(distance=best, position=position, distance2=second,
                mapped=mapped, n_candidates=ok.sum(dim=(1, 2)).to(
                    torch.int32),
                linear_dist=lin, win_start=surv_start[r_ar, win_m],
                survivors=int(passed.sum()), candidates=int(ok.sum()))


def revcomp(reads: torch.Tensor) -> torch.Tensor:
    return torch.where(reads < 4, 3 - reads.to(torch.int16),
                       reads.to(torch.int16)).to(torch.uint8).flip(-1)


def map_reads(idx: Index, reads: torch.Tensor, *, block: int = 2048) -> dict:
    """Map reads (R, read_len) uint8 on both strands.  Returns host numpy
    arrays: position, distance, distance2, mapped, strand, n_candidates,
    linear_dist (R, M, P), ops (R, max_ops), op_count, and the counts
    ``candidates`` and ``survivors`` over both strands."""
    parts = []
    for a in range(0, reads.shape[0], block):
        parts.append(_map_block(idx, reads[a : a + block]))
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]
           if k not in ("candidates", "survivors")}
    out["candidates"] = sum(p["candidates"] for p in parts)
    out["survivors"] = sum(p["survivors"] for p in parts)
    return out


def _map_block(idx: Index, reads: torch.Tensor) -> dict:
    g = idx.g
    fwd = _map_one_strand(idx, reads)
    rc_reads = revcomp(reads)
    rev = _map_one_strand(idx, rc_reads)
    take_rc = rev["distance"] < fwd["distance"]

    def pick(k):
        a, b = fwd[k], rev[k]
        m = take_rc.reshape((-1,) + (1,) * (a.dim() - 1))
        return torch.where(m, b, a)

    out = {k: pick(k) for k in ("distance", "position", "mapped",
                                "n_candidates", "linear_dist", "win_start")}
    loser = torch.where(take_rc, fwd["distance"], rev["distance"])
    out["distance2"] = torch.minimum(pick("distance2"), loser)
    out["strand"] = take_rc.to(torch.int8)
    enc = torch.where(take_rc[:, None], rc_reads, reads)
    _, dirs = dp.affine(enc, idx.windows(out["win_start"]), g.eth, g.sat,
                        want_dirs=True)
    ops, count = dp.traceback(dirs, g.eth, g.max_ops)
    out["ops"] = torch.where(out["mapped"][:, None], ops, dp.OP_NONE)
    out["op_count"] = torch.where(out["mapped"], count, 0)
    del out["win_start"]
    host = {k: v.cpu().numpy() for k, v in out.items()}
    host["candidates"] = fwd["candidates"] + rev["candidates"]
    host["survivors"] = fwd["survivors"] + rev["survivors"]
    return host
