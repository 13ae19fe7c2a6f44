"""Pre-alignment filtering (paper Sec. V-D) — torch twin of the parts of
``repro.core.filtering`` the compacted and fused engines run."""
from __future__ import annotations

import torch


def gather_windows(segments: torch.Tensor, occ_idx: torch.Tensor,
                   mini_pos: torch.Tensor, *, read_len: int, k: int,
                   eth: int) -> torch.Tensor:
    """Per-candidate reference windows cut out of materialized segments.

    segments (P_total, seg_len) uint8; occ_idx (N,) rows; mini_pos (N,)
    minimizer offsets within the read.  Returns (N, read_len + 2*eth)
    uint8 where position p holds the reference base at (expected read
    start - eth + p), i.e. segment-local index ``pad - mini_pos - eth + p``
    with ``pad = read_len + eth - k``.

    The windows are gathered as rows of the strided view of every
    length-``wlen`` slice of every segment: no per-base index is built.
    Starts are clamped into the segment, as the reference's
    ``dynamic_slice`` does.
    """
    pad = read_len + eth - k
    wlen = read_len + 2 * eth
    seg_len = segments.shape[1]
    starts = torch.clamp(pad - mini_pos - eth, 0, seg_len - wlen)
    return segments.unfold(1, wlen, 1)[occ_idx, starts]


def collapse_candidates(lin_end: torch.Tensor, threshold: int):
    """Collapse the PL axis to the best candidate per (read, minimizer)
    and apply the filter threshold.  lin_end (..., P) int32 ->
    (best_pl (...,), best_lin (...,), pass_filter (...,)); argmin ties go
    to the first index."""
    best_pl = torch.argmin(lin_end, dim=-1)
    best_lin = lin_end.gather(-1, best_pl[..., None])[..., 0]
    return best_pl, best_lin, best_lin <= threshold
