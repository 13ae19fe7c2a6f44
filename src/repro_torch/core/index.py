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
offsets are int64 here (the reference narrows them to int32).  The whole
build runs on its device, and the index keeps its tensors there.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..obs import tracing as _tracing
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


def _host(i: int, dtype):
    """The numpy field of ``tensors[i]``, made at first access."""
    def get(self) -> np.ndarray:
        return self.tensors[i].cpu().numpy().astype(dtype, copy=False)
    return functools.cached_property(get)


@dataclasses.dataclass(frozen=True)
class GenomeIndex:
    """The index's four arrays as torch tensors on the device that built
    them (``tensors``): k-mer codes int64 holding uint32 values, offsets
    and positions int64, segments uint8 — the ``Mapper``'s own layout,
    which a session on that device takes as they are.

    Host readers (sharding, the format writers, ``low_th_split``) read the
    numpy fields ``uniq_kmers`` (uint32), ``offsets``, ``positions`` and
    ``segments``, made at first access: a copy from the card paid by the
    reader alone, or a view of tensors on the CPU."""
    tensors: tuple
    read_len: int
    k: int
    w: int
    eth: int

    uniq_kmers = _host(0, np.uint32)
    offsets = _host(1, np.int64)
    positions = _host(2, np.int64)
    segments = _host(3, np.uint8)

    def to(self, device) -> "GenomeIndex":
        """This index with its tensors on ``device``: the same tensors
        where they live there already, else copies."""
        return dataclasses.replace(
            self, tensors=tuple(t.to(device) for t in self.tensors))

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
        occurrence row) plus a 1-bit-per-base sentinel mask, and the
        hash table with its CSR offsets and positions at the host fields'
        dtypes (uint32 codes, int64 offsets and positions)."""
        kmers, offsets, positions, _ = self.tensors
        n_occ = positions.numel()
        seg_bytes = n_occ * ((self.seg_len + 3) // 4
                             + (self.seg_len + 7) // 8)
        hash_table = 4 * kmers.numel() + 8 * (offsets.numel() + n_occ)
        return {
            "hash_table_bytes": hash_table,
            "materialized_segments_bytes": seg_bytes,
            "total_bytes": hash_table + seg_bytes,
            "blowup": seg_bytes / max(hash_table, 1),
        }

    @classmethod
    def from_arrays(cls, uniq_kmers, offsets, positions, segments, *,
                    read_len: int, k: int, w: int, eth: int) -> "GenomeIndex":
        """An index from the four host arrays of another builder (for
        instance the fields of ``repro.core.index.GenomeIndex``), as CPU
        tensors in this package's dtypes."""
        validate_geometry(read_len=read_len, k=k, w=w, eth=eth)
        segments = np.ascontiguousarray(segments, dtype=np.uint8)
        if segments.ndim != 2 or segments.shape[1] != 2 * (read_len + eth) - k:
            raise ValueError(f"segments shape {segments.shape} does not "
                             f"match read_len={read_len}, eth={eth}, k={k}")
        tensors = tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=dt))
                        for a, dt in ((uniq_kmers, np.int64),
                                      (offsets, np.int64),
                                      (positions, np.int64),
                                      (segments, np.uint8)))
        return cls(tensors=tensors, read_len=read_len, k=k, w=w, eth=eth)


def _scan_tile(ref, w0: int, w1: int, k: int, w: int,
               device: torch.device, backend: str):
    """Minimizers (k-mer codes, positions in ``ref``) of windows [w0, w1)
    of ``ref`` (a numpy array or a tensor): the tile cut into rows of
    ``_SCAN_ROW`` windows (``L = _SCAN_ROW + w + k - 2`` bases, neighbours
    overlapping by ``w + k - 2``), all rows in one call, the padded tail's
    windows dropped.  Windows are independent, so the rows give the
    values one row would."""
    span = w + k - 1
    n = w1 - w0
    rows = -(-n // _SCAN_ROW)
    seq = torch.zeros(rows * _SCAN_ROW + span - 1, dtype=torch.uint8,
                      device=device)
    seq[: n + span - 1].copy_(torch.as_tensor(ref[w0 : w1 + span - 1]))
    km, pos = wfb.minimizers(seq.unfold(0, _SCAN_ROW + span - 1, _SCAN_ROW),
                             k=k, w=w, backend=backend)
    pos = pos + (torch.arange(rows, device=device)[:, None] * _SCAN_ROW
                 + w0)
    return km.reshape(-1)[:n], pos.reshape(-1)[:n]


def _occurrences(ref: torch.Tensor, k: int, w: int, backend: str):
    """Distinct minimizer occurrences of ``ref`` (a tensor on the build's
    device): (kmer codes, positions), int64 on that device, ordered by
    position.

    The scan runs in tiles of windows.  A minimizer's position never
    decreases as the window slides, so repeats are adjacent: each tile
    drops them, its first window against the last position of the tile
    before, a scalar on the device.
    """
    span = w + k - 1
    n_win = len(ref) - span + 1
    kmers, poss = [], []
    last = torch.full((1,), -1, dtype=torch.int64, device=ref.device)
    for w0 in range(0, max(n_win, 0), _SCAN_TILE):
        w1 = min(w0 + _SCAN_TILE, n_win)
        km, pos = _scan_tile(ref, w0, w1, k, w, ref.device, backend)
        keep = torch.empty_like(pos, dtype=torch.bool)
        torch.ne(pos[1:], pos[:-1], out=keep[1:])
        torch.ne(pos[:1], last, out=keep[:1])
        last = pos[-1:].clone()
        kmers.append(km[keep])
        poss.append(pos[keep])
    if not kmers:
        empty = torch.zeros(0, dtype=torch.int64, device=ref.device)
        return empty, empty
    return torch.cat(kmers), torch.cat(poss)


def build_index(ref: np.ndarray, read_len: int = 150, k: int = 12,
                w: int = 30, eth: int = 6, max_pls_per_minimizer: int = 256,
                *, device=None, backend: str = "cuda") -> GenomeIndex:
    """Scan the reference, collect minimizer occurrences, materialize
    segments — ``repro.core.index.build_index``, same values.

    Everything runs on ``device`` (the card unless asked otherwise), and
    the index's tensors stay there: the minimizer scan, through the
    minimizer kernel on ``backend="cuda"`` and the plain version on
    ``"torch"`` (``core.wf_backend.minimizers``); one stable sort of the
    occurrences' codes, which keeps each k-mer's positions ascending; the
    CSR, with ``max_pls_per_minimizer`` capping hyper-repetitive
    minimizers at their lowest positions; and the segment table, gathered
    in blocks of rows from the sentinel-padded reference straight into
    its own tensor, allocated once the build's other transients are free.
    """
    validate_geometry(read_len=read_len, k=k, w=w, eth=eth)
    dev = resolve_device(device)
    ref = np.ascontiguousarray(ref, dtype=np.uint8)
    pad = read_len + eth - k
    seg_len = 2 * (read_len + eth) - k
    with _tracing.span("index.build", bases=len(ref)) as sp:
        padded = torch.full((len(ref) + 2 * pad,), SENTINEL,
                            dtype=torch.uint8, device=dev)
        padded[pad : pad + len(ref)].copy_(torch.from_numpy(ref))
        with _tracing.span("index.scan"):
            kmers, pos = _occurrences(padded[pad : pad + len(ref)], k, w,
                                      backend)
        with _tracing.span("index.sort"):
            # positions ascend already: a stable sort by code gives the
            # (kmer, position) order of the reference's np.unique
            kmers, order = torch.sort(kmers, stable=True)
            pos = pos[order]
            del order
            uniq, counts = torch.unique_consecutive(kmers,
                                                    return_counts=True)
            # its outputs keep storage for every occurrence: the index
            # keeps a copy of the codes alone
            uniq = uniq.clone()
            del kmers
            ends = torch.cumsum(counts, 0)
            rank = torch.arange(len(pos), device=dev) - (
                torch.repeat_interleave(ends - counts, counts,
                                        output_size=len(pos)))
            pos = pos[rank < max_pls_per_minimizer]
            del rank, ends
            offsets = torch.zeros(len(uniq) + 1, dtype=torch.int64,
                                  device=dev)
            torch.cumsum(counts.clamp_(max=max_pls_per_minimizer), 0,
                         out=offsets[1:])
            del counts
        with _tracing.span("index.segments"):
            # the segment of the occurrence at p is padded[p : p +
            # seg_len]: rows of a strided view, copied a bounded block of
            # rows at a time into the table
            view = padded.unfold(0, seg_len, 1)
            segs = torch.empty((len(pos), seg_len), dtype=torch.uint8,
                               device=dev)
            for a in range(0, len(pos), _GATHER_ROWS):
                b = min(a + _GATHER_ROWS, len(pos))
                torch.index_select(view, 0, pos[a:b], out=segs[a:b])
        if sp:
            sp.set(occurrences=len(pos), segment_bytes=segs.numel())
    return GenomeIndex(tensors=(uniq, offsets, pos, segs), read_len=read_len,
                       k=k, w=w, eth=eth)


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
