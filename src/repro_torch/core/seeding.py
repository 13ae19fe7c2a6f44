"""Online seeding (paper Sec. V-C) — torch twin of ``repro.core.seeding``.

For each read: its unique minimizers (padded to ``max_minis``), a binary
search of each in the sorted index, and up to ``max_pls`` potential
locations per (read, minimizer).  The reference's per-read ``vmap`` is a
batch dimension here.
"""
from __future__ import annotations

import dataclasses

import torch

from .minimizers import unique_read_minimizers


@dataclasses.dataclass(frozen=True)
class SeedParams:
    k: int = 12
    w: int = 30
    max_minis: int = 16   # unique minimizers kept per read (Reads-FIFO width)
    max_pls: int = 32     # PLs per (read, minimizer) — linear WF buffer rows


def seed_reads(uniq_kmers: torch.Tensor, offsets: torch.Tensor,
               reads: torch.Tensor, params: SeedParams = SeedParams(),
               backend: str = "cuda"):
    """Seed a batch of reads (R, L) uint8 against the index's sorted
    ``uniq_kmers`` (U,) and CSR ``offsets`` (U+1,), both int64.
    ``backend`` (``MapperConfig.wf_backend``) picks the minimizer kernel
    (``"cuda"``, for CUDA tensors) or the plain version (``"torch"``).

    Returns a dict with, per read:
      mini_kmers  (R, M)      int64   minimizer k-mer codes
      mini_pos    (R, M)      int64   minimizer start offset in the read
      mini_valid  (R, M)      bool    found in index & within max_minis
      occ_idx     (R, M, P)   int64   occurrence row (0 where invalid)
      occ_valid   (R, M, P)   bool
    and ``n_valid``, the batch's count of valid candidates (a 0-d tensor).
    """
    M, P = params.max_minis, params.max_pls
    kmers, pos, valid = unique_read_minimizers(reads, k=params.k,
                                               w=params.w, max_uniq=M,
                                               backend=backend)
    idx = torch.searchsorted(uniq_kmers, kmers)
    idx = torch.clamp(idx, max=uniq_kmers.shape[0] - 1)
    found = (uniq_kmers[idx] == kmers) & valid
    start = offsets[idx]
    count = offsets[idx + 1] - start
    lanes = torch.arange(P, device=reads.device)
    occ_valid = (lanes < count[..., None]) & found[..., None]
    occ = torch.where(occ_valid, start[..., None] + lanes, 0)
    return dict(mini_kmers=kmers, mini_pos=pos, mini_valid=found,
                occ_idx=occ, occ_valid=occ_valid,
                n_valid=occ_valid.sum())
