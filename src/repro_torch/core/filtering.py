"""Pre-alignment filtering (paper Sec. V-D) + the base-count baseline —
torch twin of ``repro.core.filtering``.

The paper replaces the popular base-count heuristic with an exact banded
linear WF distance (Sec. III-A).  Both are provided: ``base_count_filter``
is the baseline the paper cites; ``linear_wf_filter`` is DART-PIM's
mechanism, run over every (read, minimizer, placement) slot by the
padded engine.
"""
from __future__ import annotations

import torch

from . import wf_backend as wfb


def gather_windows(segments: torch.Tensor, occ_idx: torch.Tensor,
                   mini_pos: torch.Tensor, *, read_len: int, k: int,
                   eth: int) -> torch.Tensor:
    """Per-candidate reference windows cut out of materialized segments.

    segments (P_total, seg_len) uint8; occ_idx (...) rows; mini_pos
    minimizer offsets within the read, broadcast-compatible with
    ``occ_idx``.  Returns (..., read_len + 2*eth) uint8 where position p
    holds the reference base at (expected read start - eth + p), i.e.
    segment-local index ``pad - mini_pos - eth + p`` with
    ``pad = read_len + eth - k``.

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


def linear_wf_filter(reads: torch.Tensor, windows: torch.Tensor,
                     occ_valid: torch.Tensor, eth: int = 6,
                     backend: str = "cuda"):
    """Banded linear WF distance per candidate; invalid -> saturated.

    reads (R, rl); windows (R, M, P, rl + 2*eth); occ_valid (R, M, P).
    ``backend`` selects the kernel or the plain version (see
    ``core.wf_backend``).  Returns (dist_end, dist_min), each (R, M, P)
    int32 in [0, eth+1].
    """
    R, M, P, _ = windows.shape
    s1 = reads[:, None, None, :].expand(R, M, P, reads.shape[-1])
    dist_end, dist_min = wfb.linear_wf_dist(s1, windows, eth=eth,
                                            backend=backend)
    sat = eth + 1
    return (torch.where(occ_valid, dist_end, sat),
            torch.where(occ_valid, dist_min, sat))


def collapse_candidates(lin_end: torch.Tensor, threshold: int):
    """Collapse the PL axis to the best candidate per (read, minimizer)
    and apply the filter threshold.  lin_end (..., P) int32 ->
    (best_pl (...,), best_lin (...,), pass_filter (...,)); argmin ties go
    to the first index."""
    best_pl = torch.argmin(lin_end, dim=-1)
    best_lin = lin_end.gather(-1, best_pl[..., None])[..., 0]
    return best_pl, best_lin, best_lin <= threshold


def base_count_filter(reads: torch.Tensor, windows: torch.Tensor,
                      occ_valid: torch.Tensor, threshold: int = 6):
    """Base-count histogram filter [Alser et al.] — the cited baseline.

    Compares per-base counts of the read vs. the aligned reference window
    (central read_len slice); L1/2 histogram distance lower-bounds the edit
    distance restricted to substitutions+indels, so ``hist > threshold``
    safely discards.
    Returns (keep (R,M,P) bool, hist_dist (R,M,P) int32).
    """
    rl = reads.shape[-1]
    off = (windows.shape[-1] - rl) // 2
    centre = windows[..., off : off + rl]
    hist = torch.zeros(windows.shape[:-1], dtype=torch.int32,
                       device=windows.device)
    for b in range(4):
        h1 = (reads == b).sum(dim=-1).to(torch.int32)
        h2 = (centre == b).sum(dim=-1).to(torch.int32)
        hist += (h1[:, None, None] - h2).abs()
    hist = hist // 2
    return (hist <= threshold) & occ_valid, hist
