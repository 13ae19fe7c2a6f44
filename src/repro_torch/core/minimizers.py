"""Minimizer computation (k=12, W=30) — torch twin of
``repro.core.minimizers``.

A window of W consecutive k-mers is represented by the k-mer with the
smallest hash (an invertible 32-bit mix), ties to the leftmost.  Codes
and hashes are uint32 in the reference; torch lacks uint32 shifts,
comparisons, ``where`` and ``searchsorted`` on the CPU, so here they are
int64 holding the same 32-bit values.
"""
from __future__ import annotations

import torch

from .encoding import kmer_codes

_M32 = 0xFFFFFFFF


def hash32(x: torch.Tensor) -> torch.Tensor:
    """Invertible 32-bit integer mix on int64 tensors holding uint32
    values; returns the same values ``repro.core.minimizers.hash32`` gives.

    Each product of two 32-bit values can pass 2**63 and wraps modulo
    2**64 in int64; the wrap leaves the low 32 bits right, and the mask
    after every multiply keeps only those.
    """
    x = x & _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def unhash32(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``hash32`` on int64 tensors holding uint32 values:
    ``unhash32(hash32(x)) == x & 0xFFFFFFFF``.  Each step undoes one of
    hash32's in reverse order (the xor-shifts by 16 are their own
    inverses; ``x ^ (x >> 15) ^ (x >> 30)`` undoes ``x ^ (x >> 15)`` on
    32 bits; the multipliers are the inverses of hash32's modulo 2**32),
    so the minimizer kernel can return a window's k-mer code from its
    smallest hash."""
    x = x & _M32
    x = ((x ^ (x >> 16)) * 0x43021123) & _M32
    x = ((x ^ (x >> 15) ^ (x >> 30)) * 0x1D69E2A5) & _M32
    return x ^ (x >> 16)


def sliding_argmin(values: torch.Tensor, window: int):
    """Sliding-window (min, leftmost argmin) along the last axis via
    (value, index) pair doubling — the reference's schedule, so ties break
    to the leftmost index.  -> (min (..., L-window+1), argmin int64)."""
    L = values.shape[-1]
    n = L - window + 1
    val = values
    pos = torch.arange(L, device=values.device).expand(values.shape)
    span = 1
    while span < window:
        step = min(span, window - span)
        a_v, a_p = val[..., : val.shape[-1] - step], pos[..., : pos.shape[-1] - step]
        b_v, b_p = val[..., step:], pos[..., step:]
        take_b = (b_v < a_v) | ((b_v == a_v) & (b_p < a_p))
        val = torch.where(take_b, b_v, a_v)
        pos = torch.where(take_b, b_p, a_p)
        span += step
    return val[..., :n], pos[..., :n]


def minimizers(seq: torch.Tensor, k: int = 12, w: int = 30):
    """Window minimizers of ``seq`` (..., L) uint8.

    Returns (min_hash, min_kmer, min_pos), each (..., L - (w + k - 1) + 1)
    int64; ``min_pos`` is the k-mer start of the minimizer within ``seq``.
    """
    codes = kmer_codes(seq, k)
    minh, min_pos = sliding_argmin(hash32(codes), w)
    return minh, codes.gather(-1, min_pos), min_pos


def unique_read_minimizers(reads: torch.Tensor, k: int = 12, w: int = 30,
                           max_uniq: int = 24, backend: str = "cuda"):
    """Unique minimizers of each read of a batch (R, L), static-shape
    padded — ``repro.core.minimizers.unique_read_minimizers`` with the
    read axis written out.

    Keeps the ``max_uniq`` smallest distinct k-mer codes (stable sort by
    code, first occurrence of each), not the first by position.  The
    window minimizers come from ``core.wf_backend.minimizers``: the
    minimizer kernel on ``"cuda"`` (CUDA tensors), ``minimizers`` on
    ``"torch"``.  Returns (kmers, positions, valid), each (R, max_uniq);
    kmers and positions int64.
    """
    # imported here: wf_backend reaches this module through kernels.ops
    from .wf_backend import minimizers as window_minimizers
    kmer, pos = window_minimizers(reads, k=k, w=w, backend=backend)
    n_win = kmer.shape[-1]
    ks, order = torch.sort(kmer, dim=-1, stable=True)
    ps = pos.gather(-1, order)
    first = torch.ones_like(ks, dtype=torch.bool)
    first[..., 1:] = ks[..., 1:] != ks[..., :-1]
    rank = torch.cumsum(first.to(torch.int64), dim=-1) - 1
    slots = torch.where(first, rank, n_win)       # discard -> overflow slot
    lead = ks.shape[:-1]
    out_k = torch.zeros(lead + (n_win + 1,), dtype=ks.dtype,
                        device=ks.device).scatter_(-1, slots, ks)
    out_p = torch.zeros(lead + (n_win + 1,), dtype=ps.dtype,
                        device=ps.device).scatter_(-1, slots, ps)
    n_uniq = first.sum(dim=-1, keepdim=True)
    valid = (torch.arange(max_uniq, device=reads.device)
             < torch.clamp(n_uniq, max=max_uniq))
    return (out_k[..., :max_uniq].contiguous(),
            out_p[..., :max_uniq].contiguous(), valid)
