"""Offline indexing (paper Sec. V-B) — torch twin of ``repro.core.index``.

The reference genome is scanned for minimizer occurrences; every
occurrence gets its reference segment of length ``2*(rl + eth) - k``
pre-materialized (sentinel base 4 beyond the reference ends), as
DART-PIM writes segments into crossbar linear-WF buffers.

Layout (CSR over unique minimizer k-mer codes, sorted for lookup):
  uniq_kmers : (U,)   uint32  sorted unique minimizer k-mer codes
  offsets    : (U+1,) int64   CSR offsets into positions/segments
  positions  : (P,)   int64   k-mer start position of each occurrence
  segments   : (P, seg_len) uint8

The values equal the reference builder's field for field; positions and
offsets are int64 here (the reference narrows them to int32).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import wf_backend as wfb
from .device import resolve_device
from .encoding import SENTINEL

# windows per tile of the minimizer scan: bounds the scan's working set
_SCAN_TILE = 1 << 22
# windows per row of a tile: the minimizer kernel stages a row whole in a
# block's shared memory, so a tile is scanned as rows of this many
# windows, overlapping by w + k - 2 bases
_SCAN_ROW = 1024
# segment rows gathered per copy
_GATHER_ROWS = 1 << 18


def validate_geometry(*, read_len: int, k: int, w: int, eth: int) -> None:
    """Reject impossible index/mapper geometry at construction time."""
    if read_len < 1:
        raise ValueError(f"read_len={read_len!r}: read length must be >= 1")
    if not 1 <= k <= 16:
        raise ValueError(f"k={k!r}: k-mer length must be within [1, 16] — "
                         f"k-mer codes are 2-bit packed into uint32")
    if k > read_len:
        raise ValueError(f"k={k} exceeds read_len={read_len}: reads "
                         f"shorter than k produce no k-mers to seed")
    if w < 1:
        raise ValueError(f"w={w!r}: minimizer window length must be >= 1")
    if eth < 0:
        raise ValueError(f"eth={eth!r}: band half-width must be >= 0")


@dataclasses.dataclass(frozen=True)
class GenomeIndex:
    uniq_kmers: np.ndarray
    offsets: np.ndarray
    positions: np.ndarray
    segments: np.ndarray
    read_len: int
    k: int
    w: int
    eth: int

    @property
    def seg_len(self) -> int:
        return 2 * (self.read_len + self.eth) - self.k

    @property
    def pad(self) -> int:
        """Segment extent on each side of the minimizer start."""
        return self.read_len + self.eth - self.k

    def storage_bytes(self) -> dict:
        """Footprint accounting, mirroring the paper's 800MB -> 13.3GB
        note and ``repro.core.index.GenomeIndex.storage_bytes``: segments
        counted 2-bit packed per base (``ceil(seg_len/4)`` bytes per
        occurrence row) plus a 1-bit-per-base sentinel mask, and the hash
        table with its CSR offsets and positions at this index's own
        dtypes (int64 offsets and positions here)."""
        n_occ = len(self.positions)
        seg_bytes = n_occ * ((self.seg_len + 3) // 4
                             + (self.seg_len + 7) // 8)
        hash_table = (self.uniq_kmers.nbytes + self.offsets.nbytes
                      + self.positions.nbytes)
        return {
            "hash_table_bytes": hash_table,
            "materialized_segments_bytes": seg_bytes,
            "total_bytes": hash_table + seg_bytes,
            "blowup": seg_bytes / max(hash_table, 1),
        }

    @classmethod
    def from_arrays(cls, uniq_kmers, offsets, positions, segments, *,
                    read_len: int, k: int, w: int, eth: int) -> "GenomeIndex":
        """An index from the four arrays of another builder (for instance
        the fields of ``repro.core.index.GenomeIndex``), in this package's
        dtypes."""
        validate_geometry(read_len=read_len, k=k, w=w, eth=eth)
        segments = np.ascontiguousarray(segments, dtype=np.uint8)
        if segments.ndim != 2 or segments.shape[1] != 2 * (read_len + eth) - k:
            raise ValueError(f"segments shape {segments.shape} does not "
                             f"match read_len={read_len}, eth={eth}, k={k}")
        return cls(uniq_kmers=np.asarray(uniq_kmers, dtype=np.uint32),
                   offsets=np.asarray(offsets, dtype=np.int64),
                   positions=np.asarray(positions, dtype=np.int64),
                   segments=segments, read_len=read_len, k=k, w=w, eth=eth)


def _scan_tile(ref: np.ndarray, w0: int, w1: int, k: int, w: int,
               device: torch.device, backend: str):
    """Minimizers (k-mer codes, positions in ``ref``) of windows [w0, w1)
    of ``ref``: the tile cut into rows of ``_SCAN_ROW`` windows (``L =
    _SCAN_ROW + w + k - 2`` bases, neighbours overlapping by ``w + k -
    2``), all rows in one call, the padded tail's windows dropped.
    Windows are independent, so the rows give the values one row would."""
    span = w + k - 1
    n = w1 - w0
    rows = -(-n // _SCAN_ROW)
    seq = torch.zeros(rows * _SCAN_ROW + span - 1, dtype=torch.uint8,
                      device=device)
    seq[: n + span - 1] = torch.from_numpy(ref[w0 : w1 + span - 1]).to(
        device)
    km, pos = wfb.minimizers(seq.unfold(0, _SCAN_ROW + span - 1, _SCAN_ROW),
                             k=k, w=w, backend=backend)
    pos = pos + (torch.arange(rows, device=device)[:, None] * _SCAN_ROW
                 + w0)
    return km.reshape(-1)[:n], pos.reshape(-1)[:n]


def _occurrences(ref: np.ndarray, k: int, w: int, device: torch.device,
                 backend: str):
    """Distinct minimizer occurrences of ``ref``: (kmer codes, positions),
    int64, ordered by position.

    The scan runs in tiles of windows.  A minimizer's position never
    decreases as the window slides, so repeats are adjacent and each tile
    drops them before anything reaches the host.
    """
    span = w + k - 1
    n_win = len(ref) - span + 1
    kmers, poss = [], []
    last = -1
    for w0 in range(0, max(n_win, 0), _SCAN_TILE):
        w1 = min(w0 + _SCAN_TILE, n_win)
        km, pos = _scan_tile(ref, w0, w1, k, w, device, backend)
        keep = torch.ones_like(pos, dtype=torch.bool)
        keep[1:] = pos[1:] != pos[:-1]
        keep[0] = bool(pos[0] != last)
        last = int(pos[-1])
        kmers.append(km[keep].cpu().numpy())
        poss.append(pos[keep].cpu().numpy())
    if not kmers:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(kmers), np.concatenate(poss)


def build_index(ref: np.ndarray, read_len: int = 150, k: int = 12,
                w: int = 30, eth: int = 6, max_pls_per_minimizer: int = 256,
                *, device=None, backend: str = "cuda") -> GenomeIndex:
    """Scan the reference, collect minimizer occurrences, materialize
    segments — ``repro.core.index.build_index``, same values.

    The minimizer scan runs on ``device`` (the card unless asked
    otherwise), through the minimizer kernel on ``backend="cuda"`` and
    the plain version on ``"torch"`` (``core.wf_backend.minimizers``);
    the CSR and the segment table are built on the host.
    ``max_pls_per_minimizer`` caps hyper-repetitive minimizers, keeping
    the lowest positions of each.
    """
    validate_geometry(read_len=read_len, k=k, w=w, eth=eth)
    ref = np.ascontiguousarray(ref, dtype=np.uint8)
    kmers, pos = _occurrences(ref, k, w, resolve_device(device), backend)
    # (kmer, position) order, as the reference's np.unique over the pairs
    order = np.argsort(kmers, kind="stable")
    kmers, pos = kmers[order], pos[order]
    uniq, starts, counts = np.unique(kmers, return_index=True,
                                     return_counts=True)
    rank = np.arange(len(kmers)) - np.repeat(starts, counts)
    keep = rank < max_pls_per_minimizer
    pos = pos[keep]
    counts = np.minimum(counts, max_pls_per_minimizer)
    offsets = np.zeros(len(uniq) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(counts)

    pad = read_len + eth - k
    seg_len = 2 * (read_len + eth) - k
    padded = np.full(len(ref) + 2 * pad, SENTINEL, dtype=np.uint8)
    padded[pad : pad + len(ref)] = ref
    # the segment of the occurrence at p is padded[p : p + seg_len]: rows
    # of a strided view, copied a bounded block of rows at a time (fancy
    # indexing reads the view in place; np.take would first copy all of it)
    view = np.lib.stride_tricks.sliding_window_view(padded, seg_len)
    segs = np.empty((len(pos), seg_len), dtype=np.uint8)
    for a in range(0, len(pos), _GATHER_ROWS):
        b = min(a + _GATHER_ROWS, len(pos))
        segs[a:b] = view[pos[a:b]]
    return GenomeIndex(uniq_kmers=uniq.astype(np.uint32), offsets=offsets,
                       positions=pos.astype(np.int64), segments=segs,
                       read_len=read_len, k=k, w=w, eth=eth)


def minimizer_frequencies(index: GenomeIndex) -> np.ndarray:
    """PLs per unique minimizer — drives the lowTh RISC-V/crossbar split.
    int64 here (the reference's offsets are int32): the same counts."""
    return np.diff(index.offsets)


def low_th_split(index: GenomeIndex, low_th: int = 3) -> dict:
    """Paper Sec. V-A: minimizers with frequency <= lowTh are offloaded
    (to the RISC-V cores in DART-PIM).

    Returns masks + the workload split statistics that drive Eq. 6/7 —
    ``repro.core.index.low_th_split``, the same values.
    """
    freqs = minimizer_frequencies(index)
    rare = freqs <= low_th
    return {
        "rare_mask": rare,
        "n_rare_minimizers": int(rare.sum()),
        "n_minimizers": len(freqs),
        "rare_pl_fraction": float(freqs[rare].sum() / max(freqs.sum(), 1)),
        "rare_minimizer_fraction": float(rare.mean()),
    }
