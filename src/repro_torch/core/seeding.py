"""Online seeding (paper Sec. V-C) — torch twin of ``repro.core.seeding``.

For each read: its unique minimizers (padded to ``max_minis``), a binary
search of each in the sorted index, and up to ``max_pls`` potential
locations per (read, minimizer).  The reference's per-read ``vmap`` is a
batch dimension here.  ``seed_reads_routed`` seeds against a partitioned
index (``index.sharded``), routing each minimizer to its partition on the
host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..obs.tracing import span as _span
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


def _read_minimizers(reads: np.ndarray, params: SeedParams, backend: str,
                     device):
    """Each read's unique minimizers for routing, on the host: (k-mer
    codes (R, M) uint32, starts (R, M) int32, valid (R, M) bool), from
    ``unique_read_minimizers`` on ``device`` (the minimizer kernel once a
    call on ``"cuda"`` with a CUDA device, else its plain version)."""
    t = torch.from_numpy(np.ascontiguousarray(reads, dtype=np.uint8)).to(
        device)
    kmers, pos, valid = unique_read_minimizers(t, k=params.k, w=params.w,
                                               max_uniq=params.max_minis,
                                               backend=backend)
    with _span("sync", site="route_minimizers"):
        return (kmers.cpu().numpy().astype(np.uint32),
                pos.cpu().numpy().astype(np.int32), valid.cpu().numpy())


def seed_reads_routed(index, reads: np.ndarray, params: SeedParams, ensure,
                      *, backend: str = "cuda", device=None):
    """Seeding against a partitioned index — the twin of
    ``repro.core.seeding.seed_reads_routed``.

    ``index`` is an ``index.ShardedGenomeIndex`` (duck-typed: needs
    ``route(kmers)``, ``num_partitions`` and
    ``parts[p].kmers/.offsets/.n_occurrences``).  ``ensure(partition_ids)``
    is the residency hook: it makes the listed partitions resident and
    returns ``{p: arena_base_row}``; emitted ``occ_idx`` rows are arena
    rows (partition base + local CSR row).

    The chunk's read minimizers come from ``backend`` (see
    ``_read_minimizers``: the kernel on ``device`` for ``"cuda"``); the
    routing, the per-partition CSR lookups and the seeds are host numpy,
    as in the reference, so the set of partitions a chunk touches is
    known before anything of the chunk reaches the arena.  The values
    equal the reference's: ``occ_idx`` zeroed where invalid, ``n_valid``
    counted over the whole padded batch.

    Returns ``(seeds, routed_per_part, found_per_part)``: the numpy seeds
    dict (``occ_idx`` int32) and the per-partition routing and hit counts.
    """
    M, P = params.max_minis, params.max_pls
    reads = np.asarray(reads)
    kmers, pos, valid = _read_minimizers(reads, params, backend, device)
    part = np.asarray(index.route(kmers))
    R = len(reads)
    n_parts = index.num_partitions
    routed = np.bincount(part[valid], minlength=n_parts).astype(np.int64)
    touched = [int(p) for p in np.nonzero(routed)[0]
               if index.parts[p].n_occurrences > 0]
    bases = ensure(touched)
    occ = np.zeros((R, M, P), dtype=np.int32)
    occ_valid = np.zeros((R, M, P), dtype=bool)
    mini_valid = np.zeros((R, M), dtype=bool)
    found_per_part = np.zeros(n_parts, dtype=np.int64)
    lanes = np.arange(P, dtype=np.int32)
    for p in touched:
        pk = index.parts[p]
        sel = (part == p) & valid
        if not sel.any():
            continue
        kk = kmers[sel]
        pk_kmers = np.asarray(pk.kmers)
        i = np.minimum(np.searchsorted(pk_kmers, kk), pk.n_kmers - 1)
        found = pk_kmers[i] == kk
        # CSR offsets may be int64 (format v2): the row arithmetic stays
        # int64 and only the arena rows (< 2^31) are narrowed
        offs = np.asarray(pk.offsets)
        start = offs[i].astype(np.int64)
        count = offs[i + 1].astype(np.int64) - start
        rows = (np.int64(bases[p]) + start[:, None] + lanes[None, :])
        ov = (lanes[None, :] < count[:, None]) & found[:, None]
        occ[sel] = np.where(ov, rows, 0).astype(np.int32)
        occ_valid[sel] = ov
        mini_valid[sel] = found
        found_per_part[p] = int(found.sum())
    seeds = dict(mini_kmers=kmers, mini_pos=pos, mini_valid=mini_valid,
                 occ_idx=occ, occ_valid=occ_valid,
                 n_valid=int(occ_valid.sum()))
    return seeds, routed, found_per_part
