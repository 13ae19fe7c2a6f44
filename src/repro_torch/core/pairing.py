"""Paired-end resolution: proper pairs, mate rescue, MAPQ — torch twin of
``repro.core.pairing``.

DART-PIM (and this reproduction's engine) maps each mate independently;
what makes the output *paired-end* is the host-side reduce that the
paper's main controller would own.  This module is that reduce:

* **proper pairs** — both mates mapped, FR orientation (the upstream
  mate forward, the downstream mate reverse-complement: the standard
  Illumina library geometry), and an observed insert size inside a
  window derived from a **running median** of the batch's own
  concordant pairs (``InsertSizeTracker``) — no insert-size parameter
  to mistune;
* **mate rescue** — a pair with exactly one mapped mate re-aligns the
  unmapped mate with a banded affine WF sweep over the window where the
  library geometry predicts it (anchor position ± the tracked insert
  window), accepting only below a distance threshold: a real alignment,
  not a positional guess.  The sweep runs on the mapper's device through
  ``wf_backend.affine_wf_dist(..., backend=cfg.wf_backend)``: on the card
  with ``"cuda"`` that is the affine-distance kernel, where
  ``repro.core.pairing`` runs its plain version (``backend="jnp"``); the
  two are bit-identical;
* **MAPQ** — a calibrated 0..60 score per mate from the engine's
  best-vs-second-best affine distance gap (``MappingResult.distance2``,
  the runner-up at a *different* locus) plus pair concordance: proper
  pairs are promoted, discordant ones demoted, rescued mates are capped
  by their anchor's confidence.  Mapped records therefore always carry
  MAPQ <= 254 (255 stays the single-end path's "unavailable").

Apart from the rescue sweep, everything here is numpy post-processing
on the host over two ``MappingResult`` halves of one stacked engine
batch (``Mapper.map_pairs``), as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..obs.tracing import span as _span
from . import wf_backend as wfb
from .compaction import bucket_capacity
from .device import resolve_device
from .encoding import SENTINEL, revcomp
from .pipeline import MapperConfig, MappingResult

MAPQ_MAX = 60            # score ceiling (BWA/minimap2 convention, << 254)
_GAP_SCALE = 6           # MAPQ points per unit of best-vs-2nd distance gap
_PROPER_BONUS = 8        # concordant-pair promotion
_RESCUE_CAP = 17         # rescued mate: placed by its anchor, capped by it


# --------------------------------------------------------------------------
# Insert-size tracking (the running-median window)
# --------------------------------------------------------------------------

class InsertSizeTracker:
    """Running median + MAD window over observed FR insert sizes.

    ``update`` feeds the insert sizes of orientation-concordant pairs
    (bounded memory: only the most recent ``max_samples`` are kept);
    ``window()`` returns the ``[lo, hi]`` acceptance interval — median
    ± ``window_mads`` scaled-MAD half-widths, floored so a low-variance
    library cannot collapse the window to a point.  Until ``min_samples``
    inserts have been seen it reports the permissive ``default_window``,
    so the first chunk of a stream can bootstrap itself (observe, then
    resolve).
    """

    def __init__(self, *, max_samples: int = 4096, window_mads: float = 8.0,
                 min_samples: int = 32,
                 default_window: tuple[int, int] = (0, 10_000)):
        self.max_samples = max_samples
        self.window_mads = window_mads
        self.min_samples = min_samples
        self.default_window = default_window
        self._samples: list[int] = []
        self.n_observed = 0

    def update(self, inserts) -> None:
        vals = [int(v) for v in np.asarray(inserts).reshape(-1)]
        self.n_observed += len(vals)
        self._samples.extend(vals)
        if len(self._samples) > self.max_samples:
            self._samples = self._samples[-self.max_samples:]

    @property
    def median(self) -> float | None:
        if len(self._samples) < self.min_samples:
            return None
        return float(np.median(self._samples))

    def _mad_window(self) -> tuple[int, int]:
        arr = np.asarray(self._samples, dtype=np.float64)
        med = float(np.median(arr))
        mad = float(np.median(np.abs(arr - med)))
        half = max(self.window_mads * 1.4826 * mad, 0.25 * med, 16.0)
        return max(int(med - half), 0), int(med + half)

    def window(self) -> tuple[int, int]:
        if len(self._samples) < self.min_samples:
            return self.default_window
        return self._mad_window()

    def rescue_window(self, min_samples: int = 4) -> tuple[int, int] | None:
        """Insert window for the mate-rescue sweep, or None when there is
        nothing to calibrate from.  Rescue needs a *bounded* interval (a
        stride-1 WF sweep over it), so it trusts the MAD window as soon
        as a handful of concordant inserts exist — unlike :meth:`window`,
        which stays permissive until ``min_samples`` for judging
        properness."""
        if len(self._samples) < min_samples:
            return None
        return self._mad_window()


# --------------------------------------------------------------------------
# Pair resolution
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PairResolution:
    """Per-pair outcome of ``resolve_pairs`` (all arrays length n_pairs).

    ``res1``/``res2`` are *copies* of the inputs with rescued mates
    filled in (position/strand/mapped/distance); the caller's results
    are never mutated.  ``insert`` is the observed fragment length for
    orientation-concordant pairs (0 otherwise).
    """
    res1: MappingResult
    res2: MappingResult
    proper: np.ndarray       # (n,) bool — FR orientation + insert in window
    mapq1: np.ndarray        # (n,) int32 0..MAPQ_MAX
    mapq2: np.ndarray        # (n,) int32
    rescued1: np.ndarray     # (n,) bool — mate 1 was placed by rescue
    rescued2: np.ndarray     # (n,) bool
    insert: np.ndarray       # (n,) int32 observed FR fragment length
    stats: dict


def _strands(res: MappingResult) -> np.ndarray:
    s = res.strand
    if s is None:  # single-strand runs: everything mapped forward
        return np.zeros(len(res.position), dtype=np.int8)
    return np.asarray(s)


def _fr_geometry(pos1, s1, pos2, s2, read_len: int):
    """FR-orientation mask + fragment length in global flat coordinates.

    A pair is FR-oriented when the mates face each other: opposite
    strands and the forward mate upstream of (or overlapping) the
    reverse mate.  The fragment spans the forward mate's start to the
    reverse mate's end (footprint approximated by ``read_len`` — the
    band keeps true footprints within a few bases of it).
    """
    opposite = s1 != s2
    fwd_pos = np.where(s1 == 0, pos1, pos2)
    rev_pos = np.where(s1 == 0, pos2, pos1)
    facing = fwd_pos <= rev_pos
    insert = rev_pos + read_len - fwd_pos
    return opposite & facing, insert.astype(np.int32)


def _copy_result(res: MappingResult) -> MappingResult:
    fields = {f.name: getattr(res, f.name)
              for f in dataclasses.fields(MappingResult)}
    for name in ("position", "distance", "distance2", "mapped", "strand"):
        if fields[name] is not None:
            fields[name] = np.array(fields[name], copy=True)
    return MappingResult(**fields)


def _rescue_candidates(anchor_pos, anchor_strand, window, read_len,
                       max_windows: int):
    """Candidate start positions for the unmapped mate, from the anchor's
    locus and the insert window.  Stride 1 — a start offset *into* the
    band costs gap penalties (the band is end-anchored), so skipping
    starts would misprice in-between placements; when the interval
    exceeds ``max_windows`` the sweep coarsens just enough to fit."""
    lo_ins, hi_ins = window
    if anchor_strand == 0:
        # forward anchor at p: reverse mate starts in
        # [p + lo - rl, p + hi - rl]
        lo = anchor_pos + lo_ins - read_len
        hi = anchor_pos + hi_ins - read_len
    else:
        # reverse anchor ending at p + rl: forward mate starts in
        # [p + rl - hi, p + rl - lo]
        lo = anchor_pos + read_len - hi_ins
        hi = anchor_pos + read_len - lo_ins
    step = max(1, -(-(hi - lo + 1) // max_windows))
    return np.arange(lo, hi + 1, step, dtype=np.int64)


def _window_rows(ref, cfg: MapperConfig, device) -> torch.Tensor:
    """The rescue's window of every placement, as a view on ``device``:
    row ``p`` is ``ref[p - eth : p + read_len + eth]`` for each start ``p``
    at which a read fits wholly inside the reference, never-matching
    SENTINEL past its edges (as in ``repro.core.pairing._rescue``'s
    sentinel-padded copy of the reference)."""
    rl, eth = cfg.read_len, cfg.eth
    if not isinstance(ref, torch.Tensor):
        ref = torch.from_numpy(np.ascontiguousarray(ref, dtype=np.uint8))
    ref = ref.to(device)
    if len(ref) < rl:
        return ref.new_empty((0, rl + 2 * eth))
    edge = ref.new_full((eth,), SENTINEL)
    return torch.cat([edge, ref, edge]).unfold(0, rl + 2 * eth, 1)


def _rescue(res_un, res_an, idx, reads_un, windows: torch.Tensor,
            cfg: MapperConfig, window, max_dist: int, max_windows: int,
            rescued) -> int:
    """Re-align the unmapped mates ``idx`` of ``res_un`` near their
    anchors in ``res_an``; fill accepted placements in-place (``res_un``
    is already a private copy).  Returns the number rescued.

    ``windows`` is ``_window_rows``.  The sweep's rows and their order are
    ``repro.core.pairing._rescue``'s, padded to the same pow-2 bucket;
    they are gathered on the device with one index tensor."""
    rl = cfg.read_len
    idx = np.asarray(idx, dtype=np.int64)
    if not len(idx):
        return 0
    sa = _strands(res_an)[idx]
    starts, owner = [], []
    for j, i in enumerate(idx):
        s = _rescue_candidates(int(res_an.position[i]), int(sa[j]), window,
                               rl, max_windows)
        # a placement must fit wholly inside the reference (a row of
        # ``windows``): a start hanging off either edge would score
        # against sentinel padding and then emit a coordinate that
        # disagrees with the alignment
        s = s[(s >= 0) & (s < len(windows))][:max_windows]
        starts.append(s)
        owner.append(np.full(len(s), j))
    starts, owner = np.concatenate(starts), np.concatenate(owner)
    n_rows = len(starts)
    if not n_rows:
        return 0
    # FR: the rescued mate sits on the opposite strand of its anchor; the
    # engine's convention is "revcomp encoding aligned here"
    mate_strand = (1 - sa).astype(np.int8)
    aligned = np.array(np.asarray(reads_un)[idx], dtype=np.uint8)
    aligned[mate_strand == 1] = revcomp(aligned[mate_strand == 1])
    # repro.core.pairing pads to a pow-2 bucket so that its jitted sweep
    # sees shapes that repeat from chunk to chunk; the kernel gets the
    # same rows
    cap = bucket_capacity(n_rows, align=128, cap_max=n_rows)
    dev = windows.device
    s1 = torch.zeros((cap, rl), dtype=torch.uint8, device=dev)
    s1[:n_rows] = torch.from_numpy(aligned).to(dev)[
        torch.from_numpy(owner).to(dev)]
    win = torch.full((cap, windows.shape[1]), SENTINEL, dtype=torch.uint8,
                     device=dev)
    win[:n_rows] = windows[torch.from_numpy(starts).to(dev)]
    dist, _ = wfb.affine_wf_dist(s1, win, eth=cfg.eth, sat=cfg.sat_affine,
                                 backend=cfg.wf_backend)
    dist = dist[:n_rows].cpu().numpy()
    # per mate: the accepted row of least distance, then least start
    ok = dist <= max_dist
    owner, d, p = owner[ok], dist[ok], starts[ok]
    order = np.lexsort((p, d, owner))
    owner, d, p = owner[order], d[order], p[order]
    first = np.ones(len(owner), dtype=bool)
    first[1:] = owner[1:] != owner[:-1]
    owner, d, p = owner[first], d[first], p[first]
    i = idx[owner]
    res_un.position[i] = p
    res_un.distance[i] = d
    res_un.mapped[i] = True
    if res_un.strand is not None:
        res_un.strand[i] = mate_strand[owner]
    if res_un.distance2 is not None:
        # a rescue sweep sees one window, not the genome: no runner-up
        # evidence, so the gap term must not claim uniqueness
        res_un.distance2[i] = d
    rescued[i] = True
    return len(i)


def compute_mapq(distance, distance2, mapped, *, sat: int,
                 proper=None, mate_mapped=None) -> np.ndarray:
    """Calibrated 0..``MAPQ_MAX`` mapping quality per read.

    Base score is the best-vs-second-best affine distance gap
    (``distance2 - distance``; a unique locus has ``distance2 == sat``
    and earns the full gap), discounted by the winner's own distance.
    Pair concordance then adjusts: proper pairs gain ``_PROPER_BONUS``,
    discordant both-mapped pairs are halved, a lone mapped mate keeps
    its solo score.  Unmapped reads are 0.
    """
    d1 = np.asarray(distance, dtype=np.int64)
    mapped = np.asarray(mapped, dtype=bool)
    if distance2 is None:  # no runner-up accounting on this path: assume a
        d2 = d1 + 3        # modest gap rather than claiming uniqueness
    else:
        d2 = np.asarray(distance2, dtype=np.int64)
    gap = np.clip(d2 - d1, 0, sat)
    mapq = np.clip(_GAP_SCALE * gap - d1, 0, MAPQ_MAX)
    if proper is not None and mate_mapped is not None:
        proper = np.asarray(proper, dtype=bool)
        discordant = ~proper & np.asarray(mate_mapped, dtype=bool)
        mapq = np.where(proper, np.minimum(mapq + _PROPER_BONUS, MAPQ_MAX),
                        mapq)
        mapq = np.where(discordant, mapq // 2, mapq)
    return np.where(mapped, mapq, 0).astype(np.int32)


def _same_contig(pos1, pos2, contig_starts) -> np.ndarray:
    """True where both (global, flat) positions fall inside the same
    contig of a multi-contig reference.  ``contig_starts`` are the
    contigs' global offsets, sorted ascending (``Contig.offset``)."""
    starts = np.asarray(contig_starts)
    if starts.size <= 1:
        return np.ones(len(pos1), dtype=bool)
    c1 = np.searchsorted(starts, pos1, side="right")
    c2 = np.searchsorted(starts, pos2, side="right")
    return c1 == c2


def resolve_pairs(res1: MappingResult, res2: MappingResult, *,
                  cfg: MapperConfig, tracker: InsertSizeTracker | None = None,
                  ref: np.ndarray | torch.Tensor | None = None,
                  reads1: np.ndarray | None = None,
                  reads2: np.ndarray | None = None,
                  contig_starts=None,
                  rescue_max_dist: int | None = None,
                  rescue_max_windows: int = 512,
                  device=None) -> PairResolution:
    """Resolve one batch of mate results into pairs.

    ``res1``/``res2`` are the per-mate halves of a stacked batch
    (``Mapper.map_pairs``), in global flat-reference coordinates.  The
    ``tracker`` carries insert-size state across batches of a stream
    (pass the same instance to every call); this batch's own concordant
    inserts are observed *before* the window is applied, so the first
    batch bootstraps itself.  ``ref`` (the flat uint8 reference) plus
    ``reads1``/``reads2`` (the as-sequenced base codes) enable mate
    rescue; without them rescue is skipped.  ``contig_starts`` (the
    contigs' global offsets on a multi-contig reference) excludes
    cross-contig mates from FR concordance — a chimeric pair must never
    earn 0x2 or feed the insert tracker, even during the permissive
    bootstrap window.  Returns a ``PairResolution``; the inputs are not
    mutated.

    The rescue sweep runs on ``device`` (``Mapper.device``; None means the
    CUDA card, as for the ``Mapper``) through
    ``wf_backend.affine_wf_dist(..., backend=cfg.wf_backend)``.  ``ref``
    may already be a tensor there (``map_fastq`` uploads it once a run);
    a numpy ``ref`` is copied to the device each call.  Where spans
    record, the call is one ``resolve_pairs`` span and the rescue its
    ``rescue`` child.
    """
    with _span("resolve_pairs", pairs=len(res1.position)):
        return _resolve_pairs(
            res1, res2, cfg=cfg, tracker=tracker, ref=ref, reads1=reads1,
            reads2=reads2, contig_starts=contig_starts,
            rescue_max_dist=rescue_max_dist,
            rescue_max_windows=rescue_max_windows, device=device)


def _resolve_pairs(res1, res2, *, cfg, tracker, ref, reads1, reads2,
                   contig_starts, rescue_max_dist, rescue_max_windows,
                   device) -> PairResolution:
    n = len(res1.position)
    if len(res2.position) != n:
        raise ValueError(f"mate result batches must align pairwise: "
                         f"{n} vs {len(res2.position)}")
    tracker = tracker if tracker is not None else InsertSizeTracker()
    res1, res2 = _copy_result(res1), _copy_result(res2)
    m1, m2 = np.asarray(res1.mapped, bool), np.asarray(res2.mapped, bool)
    s1, s2 = _strands(res1), _strands(res2)

    def _concordant(mapped_both):
        fr, ins = _fr_geometry(res1.position, s1, res2.position, s2,
                               cfg.read_len)
        fr &= mapped_both
        if contig_starts is not None:
            fr &= _same_contig(res1.position, res2.position, contig_starts)
        return fr, ins

    both = m1 & m2
    fr, insert = _concordant(both)
    tracker.update(insert[fr])  # observe before judging: running median

    n_rescued = 0
    rescued1 = np.zeros(n, dtype=bool)
    rescued2 = np.zeros(n, dtype=bool)
    win = (tracker.rescue_window() if ref is not None
           and reads1 is not None and reads2 is not None else None)
    if win is not None:
        max_dist = cfg.eth if rescue_max_dist is None else rescue_max_dist
        # quarantined reads (resilience layer: block failed after retries)
        # carry synthesized unmapped rows — their bases never went through
        # the engine, so they must neither anchor a rescue nor be rescued
        f1 = res1.failed if res1.failed is not None else np.zeros(n, bool)
        f2 = res2.failed if res2.failed is not None else np.zeros(n, bool)
        only1 = np.flatnonzero(m1 & ~m2 & ~f1 & ~f2)
        only2 = np.flatnonzero(m2 & ~m1 & ~f1 & ~f2)
        with _span("rescue") as sp:
            windows = _window_rows(ref, cfg, resolve_device(device))
            n_rescued += _rescue(res2, res1, only1, np.asarray(reads2),
                                 windows, cfg, win, max_dist,
                                 rescue_max_windows, rescued2)
            n_rescued += _rescue(res1, res2, only2, np.asarray(reads1),
                                 windows, cfg, win, max_dist,
                                 rescue_max_windows, rescued1)
            if sp is not None:
                sp.set(mates=len(only1) + len(only2), rescued=n_rescued)
        if n_rescued:  # rescued placements can complete proper pairs
            m1 = np.asarray(res1.mapped, bool)
            m2 = np.asarray(res2.mapped, bool)
            both = m1 & m2
            s1, s2 = _strands(res1), _strands(res2)
            fr, insert = _concordant(both)

    lo, hi = tracker.window()
    proper = fr & (insert >= lo) & (insert <= hi)
    insert = np.where(fr, insert, 0).astype(np.int32)

    mapq1 = compute_mapq(res1.distance, res1.distance2, m1,
                         sat=cfg.sat_affine, proper=proper, mate_mapped=m2)
    mapq2 = compute_mapq(res2.distance, res2.distance2, m2,
                         sat=cfg.sat_affine, proper=proper, mate_mapped=m1)
    # a rescued mate exists only because its anchor placed it: its
    # confidence cannot exceed the anchor's
    mapq2 = np.where(rescued2, np.minimum(np.minimum(mapq1, _RESCUE_CAP),
                                          mapq2), mapq2)
    mapq1 = np.where(rescued1, np.minimum(np.minimum(mapq2, _RESCUE_CAP),
                                          mapq1), mapq1)

    stats = dict(n_pairs=n, n_both_mapped=int(both.sum()),
                 n_proper=int(proper.sum()), n_rescued=n_rescued,
                 n_discordant=int((both & ~proper).sum()),
                 insert_median=tracker.median,
                 insert_window=(lo, hi))
    return PairResolution(res1=res1, res2=res2, proper=proper,
                          mapq1=mapq1, mapq2=mapq2,
                          rescued1=rescued1, rescued2=rescued2,
                          insert=insert, stats=stats)
