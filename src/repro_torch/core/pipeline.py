"""End-to-end read mapping (paper Secs. V-B .. V-E), single device — torch
twin of ``repro.core.pipeline``'s three engines.

Stages (numbers = the circled steps of paper Fig. 6):
  (1)(2) seeding     — minimizer lookup, candidate PLs       (seeding.py)
  (3)    linear WF   — banded distance for every valid candidate
  (4)    min extract — best PL per (read, minimizer) + filter threshold
  (5)    affine WF   — distance-only pass on the filter survivors
  (7)    reduce      — best locus per read, runner-up distance
  (6)    traceback   — fused affine WF + traceback on one winner per read

``engine="compacted"`` compacts valid candidates into power-of-two,
``block_r``-aligned buckets whose sizes the host reads between stages
(``.item()`` syncs); ``engine="fused"`` bounds the affine bucket from the
candidate count alone and runs the back half without a second sync.
``engine="padded"`` (``map_reads_padded``) is the reference engine: the
linear WF over every (R, M, P) slot, valid or not, and the
dirs-emitting affine WF over every (R, M) winner.  All three give the
same results as each other and as the reference, bit for bit.

``oracle_map`` is the exhaustive banded-WF scan the accuracy tests use as
ground truth; ``map_reads`` is the deprecated one-shot wrapper.

Device positions are int64: the winner sentinel is the int64 max and
unmapped reads carry -1.
"""
from __future__ import annotations

import dataclasses
import mmap
import warnings

import numpy as np
import torch

from ..obs.tracing import span as _span
from . import wf_backend as wfb
from .affine_wf import traceback
from .compaction import bucket_capacity, compact_indices, scatter_to
from .device import resolve_device
from .encoding import OP_NONE, revcomp
from .filtering import collapse_candidates, gather_windows, linear_wf_filter
from .index import GenomeIndex, validate_geometry
from .linear_wf import banded_wf
from .seeding import SeedParams, seed_reads


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    read_len: int = 150
    k: int = 12
    w: int = 30
    eth: int = 6            # band half-width (linear + affine) — Table III
    sat_affine: int = 32    # affine value saturation (5-bit cells) — Table III
    max_minis: int = 16
    max_pls: int = 32       # linear WF buffer rows per crossbar
    filter_threshold: int = 6
    max_ops: int | None = None
    engine: str = "compacted"     # "compacted" | "fused" | "padded"
    wf_backend: str = "cuda"      # "cuda" | "torch"  (see core.wf_backend)
    cigar_mode: str = "eager"     # "eager" | "lazy" | "off": when the
    #                               traceback pass runs.
    #                               eager = with the batch (default);
    #                               lazy  = deferred until the first
    #                               MappingResult.ops/op_count access;
    #                               off   = never
    lin_block_r: int = 512        # linear bucket alignment
    aff_block_r: int = 256        # affine bucket alignment
    chunk_reads: int | None = None  # stream reads in chunks of this size
    both_strands: bool = False    # map forward + reverse-complement encodings
    #                               of every read; best (pos, dist, strand)
    #                               wins
    stream: bool = True           # overlapped chunk schedule; False = fully
    #                               synchronous path with per-stage wall
    #                               times in stats
    stage_b_survivor_frac: float = 0.5  # mesh stage B survivor capacity
    profile: bool = False         # streamed path: stats["stage_times_s"]
    #                               holds each stage span's summed wall
    #                               seconds on its thread (the host's
    #                               dispatch, h2d, d2h on the fetch
    #                               thread; stream=False fills it always)
    stage_b_adaptive: bool = False  # mesh stage B: size the capacity
    #                               from the survivor history
    stage_b_quantile: float = 0.9
    stage_b_history: int = 32

    ENGINES = ("compacted", "fused", "padded")
    WF_BACKENDS = ("cuda", "torch")
    CIGAR_MODES = ("eager", "lazy", "off")

    def __post_init__(self):
        """Reject invalid configurations at construction time, with errors
        that name the field."""
        validate_geometry(read_len=self.read_len, k=self.k, w=self.w,
                          eth=self.eth)
        if self.engine not in self.ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; expected one "
                             f"of {self.ENGINES}")
        if self.wf_backend not in self.WF_BACKENDS:
            raise ValueError(f"unknown wf_backend {self.wf_backend!r}; "
                             f"expected one of {self.WF_BACKENDS}")
        for name in ("lin_block_r", "aff_block_r"):
            v = getattr(self, name)
            if not (isinstance(v, int) and v >= 1 and (v & (v - 1)) == 0):
                raise ValueError(
                    f"{name}={v!r} must be a positive power of two: it is "
                    f"the bucket-capacity alignment (see "
                    f"repro_torch.core.compaction)")
        if self.chunk_reads is not None and self.chunk_reads < 1:
            raise ValueError(f"chunk_reads={self.chunk_reads!r} must be "
                             f">= 1 (or None for unchunked)")
        if self.cigar_mode not in self.CIGAR_MODES:
            raise ValueError(f"unknown cigar_mode {self.cigar_mode!r}; "
                             f"expected one of {self.CIGAR_MODES}")
        if self.engine == "padded" and self.cigar_mode != "eager":
            raise ValueError(
                'engine="padded" is the fully-eager reference and only '
                f'supports cigar_mode="eager", got {self.cigar_mode!r}')
        if not 0.0 <= self.stage_b_quantile <= 1.0:
            raise ValueError(f"stage_b_quantile={self.stage_b_quantile!r} "
                             f"must be within [0, 1]")
        if self.stage_b_history < 1:
            raise ValueError(f"stage_b_history={self.stage_b_history!r} "
                             f"must be >= 1")

    @classmethod
    def from_index(cls, index, **overrides) -> "MapperConfig":
        """Config matching an index's geometry, with ``overrides`` on top."""
        base = dict(read_len=index.read_len, k=index.k, w=index.w,
                    eth=index.eth)
        base.update(overrides)
        return cls(**base)

    @property
    def seed_params(self) -> SeedParams:
        return SeedParams(k=self.k, w=self.w, max_minis=self.max_minis,
                          max_pls=self.max_pls)


@dataclasses.dataclass
class MappingResult:
    """Mapping output, the schema of ``repro.core.pipeline.MappingResult``.

    With ``cigar_mode="lazy"`` the ``ops``/``op_count`` fields start as
    ``None`` and ``lazy_tb`` carries the per-read winner metadata; the
    first access of either field runs the deferred traceback.
    """
    position: np.ndarray   # (R,) int64 best mapping position, -1 if unmapped
    distance: np.ndarray   # (R,) int32 affine WF distance
    mapped: np.ndarray     # (R,) bool
    distance2: np.ndarray | None = None  # (R,) int32 runner-up distance at
    #                      a different locus (sat_affine when none)
    strand: np.ndarray | None = None  # (R,) int8 0=forward 1=reverse-
    #                      complement winner; None on single-strand runs
    ops: np.ndarray | None = None   # (R, max_ops) traceback ops (END-aligned)
    op_count: np.ndarray | None = None  # (R,) int32
    linear_dist: np.ndarray | None = None  # (R, M, P) candidate linear dists
    n_candidates: np.ndarray | None = None  # (R,) valid PLs seeded
    stats: object | None = None  # MapperStats
    failed: np.ndarray | None = None  # (R,) bool; set by a resilience layer
    lazy_tb: object | None = None  # LazyTraceback (cigar_mode="lazy")

    def __getattribute__(self, name):
        if name in ("ops", "op_count"):
            lt = object.__getattribute__(self, "lazy_tb")
            if lt is not None:
                object.__setattr__(self, "lazy_tb", None)
                ops, cnt = lt.materialize()
                object.__setattr__(self, "ops", ops)
                object.__setattr__(self, "op_count", cnt)
        return object.__getattribute__(self, name)


_POS_BIG = torch.iinfo(torch.int64).max
_PAGE = mmap.PAGESIZE


def _cand_positions(positions, occ, mini_pos):
    """Candidate genome positions ``positions[occ] - mini_pos`` and their
    validity (the read would start before the reference).  Positions are
    int64, or the 32-bit words of a sharded index's arena
    (``index.residency.arena_position_dtype``), read as unsigned."""
    p = positions[occ]
    if p.dtype == torch.int32:
        p = p.to(torch.int64) & 0xFFFFFFFF
    cp = p - mini_pos
    return cp, cp >= 0


def _runner_up_distance(aff_end, cand_pos, cand_ok, position, eth: int,
                        sat: int):
    """Best affine distance among candidates more than ``eth`` away from
    the winner; ``sat`` when no competing locus exists."""
    far = (cand_pos - position[:, None]).abs() > eth
    key = torch.where((aff_end < sat) & far & cand_ok, aff_end, sat)
    return key.amin(dim=-1).to(torch.int32)


def _co_optimal_runner_up(lin_end, occ_idx, mini_pos, positions, position,
                          best_m, best_aff, distance2, cfg: MapperConfig):
    """Fold placement-level competitors into ``distance2``: a far-locus
    placement within the filter threshold that the per-minimizer collapse
    hid, its affine distance estimated as the winner's plus its
    linear-distance excess."""
    eth, sat = cfg.eth, cfg.sat_affine
    sat_lin = eth + 1
    pos_all, _ = _cand_positions(positions, occ_idx, mini_pos[..., None])
    far = (pos_all - position[:, None, None]).abs() > eth
    cand = far & (lin_end <= min(cfg.filter_threshold, eth))
    min_far = torch.where(cand, lin_end, sat_lin).amin(dim=(1, 2))
    lin_w_all = lin_end.amin(dim=-1)                            # (R, M)
    lin_w = lin_w_all.gather(1, best_m[:, None])[:, 0]
    est = torch.clamp(best_aff + torch.clamp(min_far - lin_w, min=0),
                      max=sat)
    return torch.where(min_far < sat_lin,
                       torch.minimum(distance2, est.to(torch.int32)),
                       distance2)


def _linear_stage(segments, reads, occ_idx, occ_valid, mini_pos,
                  cfg: MapperConfig, cap: int):
    """(3)+(4): compact valid candidates -> linear WF on ``cap`` instances
    -> scatter distances back -> per-(read, minimizer) min + filter."""
    R = reads.shape[0]
    M, P = cfg.max_minis, cfg.max_pls
    N = R * M * P
    sat = cfg.eth + 1

    slots, slot_ok = compact_indices(occ_valid.reshape(-1), cap)
    r_idx = slots // (M * P)
    m_idx = (slots // P) % M
    occ = occ_idx.reshape(-1)[slots]
    mpos = mini_pos[r_idx, m_idx]

    wins = gather_windows(segments, occ, mpos, read_len=cfg.read_len,
                          k=cfg.k, eth=cfg.eth)                  # (cap, wlen)
    de, _ = wfb.linear_wf_dist(reads[r_idx], wins, eth=cfg.eth,
                               backend=cfg.wf_backend)
    de = torch.where(slot_ok, de, sat).to(torch.int32)
    lin_end = scatter_to(N, slots, slot_ok, de, sat).reshape(R, M, P)

    best_pl, _, pass_filter = collapse_candidates(lin_end,
                                                  cfg.filter_threshold)
    n_cand = occ_valid.sum(dim=(1, 2)).to(torch.int32)
    return lin_end, best_pl, pass_filter, n_cand


def _affine_stage(segments, positions, reads, occ_idx, mini_pos, best_pl,
                  pass_filter, lin_end_full, cfg: MapperConfig, cap: int):
    """(5)+(7): distance-only affine WF on the compacted filter survivors,
    then the per-read winner reduce: min distance, ties -> leftmost
    position.  Also returns the winner's occurrence row and minimizer
    offset, all the traceback pass needs."""
    R = reads.shape[0]
    M = cfg.max_minis
    sat = cfg.sat_affine
    dev = reads.device

    slots, slot_ok = compact_indices(pass_filter.reshape(-1), cap)
    r_idx = slots // M
    m_idx = slots % M
    pl = best_pl.reshape(-1)[slots]
    occ = occ_idx[r_idx, m_idx, pl]
    mpos = mini_pos[r_idx, m_idx]

    wins = gather_windows(segments, occ, mpos, read_len=cfg.read_len,
                          k=cfg.k, eth=cfg.eth)                  # (cap, wlen)
    ae, _ = wfb.affine_wf_dist(reads[r_idx], wins, eth=cfg.eth, sat=sat,
                               backend=cfg.wf_backend)
    ae = torch.where(slot_ok, ae, sat).to(torch.int32)
    aff_end = scatter_to(R * M, slots, slot_ok, ae, sat).reshape(R, M)

    best_aff, mapped, position, best_m, distance2, cand_occ = _reduce(
        aff_end, occ_idx, best_pl, mini_pos, positions, lin_end_full, cfg)
    r = torch.arange(R, device=dev)
    occ_w = cand_occ[r, best_m]
    mpos_w = mini_pos[r, best_m]
    return best_aff, mapped, position, best_m, distance2, occ_w, mpos_w


def _reduce(aff_end, occ_idx, best_pl, mini_pos, positions, lin_end,
            cfg: MapperConfig):
    """(7) the per-read winner over the (R, M) affine distances: min
    distance, ties -> leftmost position (then the first minimizer), and
    the runner-up distance.  Returns (best_aff, mapped, position, best_m,
    distance2, cand_occ) with ``cand_occ`` each (read, minimizer)'s
    occurrence row."""
    M = cfg.max_minis
    sat = cfg.sat_affine
    cand_occ = occ_idx.gather(2, best_pl[..., None])[:, :, 0]
    cand_pos, cand_ok = _cand_positions(positions, cand_occ, mini_pos)
    best_aff = aff_end.amin(dim=-1)
    mapped = best_aff < sat
    is_best = aff_end == best_aff[:, None]
    pos_key = torch.where(is_best & cand_ok, cand_pos, _POS_BIG)
    position = pos_key.amin(dim=-1)
    m_ar = torch.arange(M, device=aff_end.device)
    best_m = torch.argmin(torch.where(pos_key == position[:, None], m_ar, M),
                          dim=-1)
    position = torch.where(mapped & (position < _POS_BIG), position, -1)
    distance2 = _runner_up_distance(aff_end, cand_pos, cand_ok, position,
                                    cfg.eth, sat)
    distance2 = _co_optimal_runner_up(lin_end, occ_idx, mini_pos,
                                      positions, position, best_m,
                                      best_aff, distance2, cfg)
    return best_aff, mapped, position, best_m, distance2, cand_occ


def map_reads_padded(uniq_kmers, offsets, positions, segments, reads,
                     cfg: MapperConfig):
    """The padded reference engine (``repro.core.pipeline.map_reads_jax``):
    every (R, M, P) slot, valid or not, goes through the linear WF, every
    (R, M) winner through the dirs-emitting affine WF, and the plain
    traceback walks the winning minimizer's direction planes.  Index
    tensors on the reads' device; reads (R, rl) uint8.  Returns a dict of
    per-read tensors."""
    R = reads.shape[0]
    M, n, eth = cfg.max_minis, cfg.read_len, cfg.eth
    sat = cfg.sat_affine
    seeds = seed_reads(uniq_kmers, offsets, reads, cfg.seed_params,
                       backend=cfg.wf_backend)
    occ_idx, occ_valid = seeds["occ_idx"], seeds["occ_valid"]
    mini_pos = seeds["mini_pos"]

    # (3) linear WF over every candidate
    windows = gather_windows(segments, occ_idx, mini_pos[..., None],
                             read_len=n, k=cfg.k, eth=eth)   # (R, M, P, wlen)
    lin_end, _ = linear_wf_filter(reads, windows, occ_valid, eth=eth,
                                  backend=cfg.wf_backend)

    # (4) min extraction per (read, minimizer); filter threshold
    best_pl, _, pass_filter = collapse_candidates(lin_end,
                                                  cfg.filter_threshold)

    # (5)+(6) affine WF on the per-minimizer winners
    wlen = windows.shape[-1]
    sel_win = windows.gather(
        2, best_pl[..., None, None].expand(R, M, 1, wlen))[:, :, 0]
    del windows     # the batch's largest tensor: free it before the
    #                 direction planes are allocated
    s1 = reads[:, None, :].expand(R, M, n)
    aff_end, _, dirs = wfb.affine_wf_dirs(s1, sel_win, eth=eth, sat=sat,
                                          backend=cfg.wf_backend)
    aff_end = torch.where(pass_filter, aff_end, sat)

    # (7) best minimizer per read
    best_aff, mapped, position, best_m, distance2, _ = _reduce(
        aff_end, occ_idx, best_pl, mini_pos, positions, lin_end, cfg)

    # traceback for the winning instance only
    sel_dirs = dirs[torch.arange(R, device=reads.device), best_m]
    max_ops = cfg.max_ops or 2 * n + 2
    ops, op_count = traceback(sel_dirs, eth, max_ops)
    ops = torch.where(mapped[:, None], ops, OP_NONE)
    op_count = torch.where(mapped, op_count, 0)
    return dict(position=position, distance=best_aff, distance2=distance2,
                mapped=mapped, ops=ops, op_count=op_count,
                linear_dist=lin_end,
                n_candidates=occ_valid.sum(dim=(1, 2)).to(torch.int32))


def _winner_traceback(segments, reads, occ, mpos, mapped,
                      cfg: MapperConfig):
    """(6): fused affine WF + traceback on the per-read winners only; the
    END-aligned op rows and counts are the only O(max_ops) arrays made."""
    wins = gather_windows(segments, occ, mpos, read_len=cfg.read_len,
                          k=cfg.k, eth=cfg.eth)                  # (R, wlen)
    max_ops = cfg.max_ops or 2 * cfg.read_len + 2
    _, _, ops, op_count = wfb.affine_traceback(
        reads, wins, eth=cfg.eth, sat=cfg.sat_affine, max_ops=max_ops,
        backend=cfg.wf_backend)
    ops = torch.where(mapped[:, None], ops, OP_NONE)
    op_count = torch.where(mapped, op_count, 0)
    return ops, op_count


def _strand_fold(distance, mapped, position, distance2, n_cand, occ_w,
                 mpos_w, reads, lin_end=None):
    """Device-side fwd-vs-rc winner fold: rows ``[0:n)`` are the forward
    encodings, ``[n:2n)`` their reverse complements.  Lower affine distance
    wins; ties keep forward.  The runner-up becomes min(winner strand's
    second locus, loser strand's best)."""
    n = distance.shape[0] // 2
    rev = distance[n:] < distance[:n]

    def pick(a):
        return torch.where(rev.reshape((-1,) + (1,) * (a.dim() - 1)),
                           a[n:], a[:n])

    lose_d1 = torch.where(rev, distance[:n], distance[n:])
    out = dict(distance=pick(distance), mapped=pick(mapped),
               position=pick(position),
               distance2=torch.minimum(pick(distance2),
                                       lose_d1).to(torch.int32),
               n_candidates=pick(n_cand), occ_w=pick(occ_w),
               mpos_w=pick(mpos_w), reads_w=pick(reads),
               strand=rev.to(torch.int8))
    if lin_end is not None:
        out["linear_dist"] = pick(lin_end)
    return out, rev


def _strand_stage(distance, mapped, position, distance2, n_cand, occ_w,
                  mpos_w, reads, lin_end, n_real: int):
    """Strand fold for the staged engine, plus the ``reverse_best`` count
    over the ``n_real`` non-padding reads."""
    out, rev = _strand_fold(distance, mapped, position, distance2, n_cand,
                            occ_w, mpos_w, reads, lin_end)
    n = distance.shape[0] // 2
    real = torch.arange(n, device=distance.device) < n_real
    out["reverse_best"] = (rev & out["mapped"] & real).sum()
    return out


def _fused_stage(segments, positions, reads, occ_idx, occ_valid, mini_pos,
                 n_real: int, cfg: MapperConfig, lin_cap: int, aff_cap: int):
    """The single-dispatch engine: compaction -> linear WF -> filter ->
    affine WF -> strand fold -> traceback with no host sync; the affine
    capacity comes from ``fused_affine_capacity``.  The (R, M, P)
    ``linear_dist`` is not returned."""
    R = reads.shape[0]
    half = R // 2 if cfg.both_strands else R
    real = (torch.arange(R, device=reads.device) % half) < n_real

    lin_end, best_pl, pass_filter, n_cand = _linear_stage(
        segments, reads, occ_idx, occ_valid, mini_pos, cfg, lin_cap)
    (best_aff, mapped, position, best_m, distance2, occ_w,
     mpos_w) = _affine_stage(segments, positions, reads, occ_idx, mini_pos,
                             best_pl, pass_filter, lin_end, cfg, aff_cap)
    out = dict(survivors=(pass_filter & real[:, None]).sum())
    reads_w = reads
    if cfg.both_strands:
        fold, rev = _strand_fold(best_aff, mapped, position, distance2,
                                 n_cand, occ_w, mpos_w, reads)
        best_aff, mapped, position = (fold["distance"], fold["mapped"],
                                      fold["position"])
        distance2, n_cand = fold["distance2"], fold["n_candidates"]
        occ_w, mpos_w, reads_w = fold["occ_w"], fold["mpos_w"], \
            fold["reads_w"]
        out["strand"] = fold["strand"]
        out["reverse_best"] = (rev & mapped & real[:half]).sum()
    out.update(position=position, distance=best_aff, distance2=distance2,
               mapped=mapped, n_candidates=n_cand)
    if cfg.cigar_mode == "eager":
        out["ops"], out["op_count"] = _winner_traceback(
            segments, reads_w, occ_w, mpos_w, mapped, cfg)
    elif cfg.cigar_mode == "lazy":
        out.update(_tb_reads=reads_w, _tb_occ=occ_w, _tb_mpos=mpos_w)
    return out


def fused_affine_capacity(n_valid: int, R: int, cfg: MapperConfig) -> int:
    """Affine-survivor capacity for the fused engine, bounded without a
    post-filter sync: at most ``min(n_valid, R*M)`` (read, minimizer)
    groups survive, exactly ``R*M`` when the threshold disables the
    filter — never fewer than the true survivor count."""
    M = cfg.max_minis
    bound = R * M if cfg.filter_threshold > cfg.eth else min(n_valid, R * M)
    return bucket_capacity(bound, align=cfg.aff_block_r, cap_max=R * M)


class LazyTraceback:
    """Deferred winners-only traceback (``cigar_mode="lazy"``): the
    per-read winner metadata fetched with the batch, plus the session's
    device segments; ``materialize`` runs the same traceback pass the
    eager mode runs.  Slicing and concatenation keep results lazy through
    ``mapper.split_result`` and the serving layer's reassembly."""

    def __init__(self, segments, cfg: MapperConfig, reads, occ, mpos,
                 mapped):
        self.segments = segments        # device tensor, shared not copied
        self.cfg = cfg
        self.reads, self.occ, self.mpos = reads, occ, mpos
        self.mapped = mapped

    def __len__(self):
        return len(self.occ)

    def __getitem__(self, sl):
        return LazyTraceback(self.segments, self.cfg, self.reads[sl],
                             self.occ[sl], self.mpos[sl], self.mapped[sl])

    @classmethod
    def concat(cls, parts: list["LazyTraceback"]) -> "LazyTraceback":
        first = parts[0]
        if len(parts) == 1:
            return first
        return cls(first.segments, first.cfg,
                   np.concatenate([p.reads for p in parts]),
                   np.concatenate([p.occ for p in parts]),
                   np.concatenate([p.mpos for p in parts]),
                   np.concatenate([p.mapped for p in parts]))

    def materialize(self):
        dev = self.segments.device
        ops, cnt = _winner_traceback(
            self.segments, torch.as_tensor(self.reads, device=dev),
            torch.as_tensor(self.occ, device=dev),
            torch.as_tensor(self.mpos, device=dev),
            torch.as_tensor(self.mapped, device=dev), self.cfg)
        # C order, as the fetched fields (the plain traceback's is F)
        return ops.contiguous().cpu().numpy(), cnt.cpu().numpy()


def _host_int(v, site: str) -> int:
    """``int(v)``; where ``v`` is a tensor, that blocks the host until the
    device has made it, and is recorded as a ``sync`` span at ``site``."""
    if not isinstance(v, torch.Tensor):
        return int(v)
    with _span("sync", site=site):
        return int(v)


def _copy_args(sp, host: list) -> None:
    """A copy span's arguments from the host side of its copies (the
    sources of an upload, the results of a fetch): ``bytes``, ``copies``
    and ``pageable``, that not all of them are in pinned memory."""
    sp.set(bytes=sum(t.nbytes for t in host), copies=len(host),
           pageable=not all(t.is_pinned() for t in host))


class _CallArrays:
    """A chunk-engine call's own result arrays, which each chunk's fetch
    fills in place: one C-contiguous ``np.ndarray`` a per-read field, of
    the call's ``n`` rows, with the device output's dtype and trailing
    shape, allocated at the first fetch.  Fetches run one at a time in
    chunk order (the one fetch thread takes them in submission order, the
    synchronous schedule in turn), so each chunk's rows follow the last
    one's.  Made anew for every call: no result shares memory with
    another's, and a fetch abandoned by the watchdog writes only into its
    failed call's.

    The arrays' pages are fresh, and a pageable copy from the device
    holds the stream while it faults them in.  So the fetch thread
    touches a chunk's rows before they are copied: the next chunk's
    right after each copy, while the device still works on it."""

    def __init__(self, n: int):
        self.n = n
        self.arrays: dict[str, np.ndarray] = {}
        self.rows = 0

    def place(self, out: dict, n_real: int) -> list:
        """Rows ``[:n_real]`` of each device output in ``out`` copied into
        the next ``n_real`` rows of its array, and the output taken out of
        ``out``, so that the device frees it before the next chunk's rows
        are touched; returns the host views written."""
        if not self.arrays:
            self.arrays = {
                k: np.empty((self.n, *v.shape[1:]),
                            torch.empty(0, dtype=v.dtype).numpy().dtype)
                for k, v in out.items()}
            self._touch(0, n_real)
        r0 = self.rows
        self.rows += n_real
        dst = []
        for k in list(out):
            dst.append(torch.from_numpy(self.arrays[k][r0:self.rows]))
            dst[-1].copy_(out.pop(k)[:n_real])
        self._touch(self.rows, self.rows + n_real)
        return dst

    def _touch(self, r0: int, r1: int) -> None:
        """Fault in the pages of rows ``[r0, r1)``: one byte a page."""
        for a in self.arrays.values():
            a[r0:r1].reshape(-1).view(np.uint8)[::_PAGE] = 0


class _ChunkPipeline:
    """Phase-split per-chunk execution for ``streaming``'s schedules.

      phase1: host pad (+ reverse complements) -> H2D -> seeding
      phase2: capacity-count syncs -> linear/affine/traceback
      fetch:  device -> the call's result rows, padding left behind
              (fetch thread)

    Each stage is a span of ``obs.tracing`` (``stage_times_s``'s names);
    given a ``times`` dict, the stages add their wall seconds there.  On
    the synchronous schedule (``cfg.stream`` False) every stage also waits
    for the device at its end.  Candidate/survivor accounting excludes the
    zero-padding reads of a partial last chunk.
    """

    def __init__(self, dev, cfg: MapperConfig, device: torch.device):
        self.dev = dev          # (uniq_kmers, offsets, positions, segments)
        self.cfg = cfg
        self.device = device

    def begin_run(self, items, times=None) -> None:
        """Hook called once with the full chunk list (and the run's
        ``times``) before streaming begins.  The flat pipeline has nothing
        to stage; the routed pipeline (``index.residency``) starts its
        prefetch here."""

    def chunk_index(self, seeds):
        """Device ``(positions, segments)`` that this chunk's ``occ_idx``
        rows point into: the session's flat index here; the routed
        pipeline returns the arena with this chunk's writes applied."""
        return self.dev[2], self.dev[3]

    def _wait(self, t: torch.Tensor) -> None:
        """The synchronous schedule's stage boundary: wait for the device
        work that produces ``t`` (no-op on the CPU)."""
        if not self.cfg.stream and t.is_cuda:
            torch.cuda.synchronize(t.device)

    def host_prep(self, item, times=None):
        """The chunk's rows as the device takes them, and its real read
        count: zero-padded to the chunk's fixed shape (trimmed in fetch),
        with ``both_strands`` the reverse complements stacked under it."""
        sub, chunk = item
        n_real = len(sub)
        with _span("host_prep", times):
            if n_real < chunk:
                sub = np.concatenate(
                    [sub, np.zeros((chunk - n_real, sub.shape[1]),
                                   sub.dtype)])
            if self.cfg.both_strands:
                # rows [0:chunk) forward, [chunk:2*chunk) reverse complement
                sub = np.concatenate([sub, revcomp(sub)])
            return np.ascontiguousarray(sub, dtype=np.uint8), n_real

    def phase1(self, item, times=None):
        sub, n_real = self.host_prep(item, times)
        with _span("h2d", times) as sp:
            host = torch.from_numpy(sub)
            reads = host.to(self.device)
            self._wait(reads)
            if sp is not None:
                _copy_args(sp, [host])
        with _span("seed", times):
            seeds = seed_reads(self.dev[0], self.dev[1], reads,
                               self.cfg.seed_params,
                               backend=self.cfg.wf_backend)
            self._wait(reads)
        return reads, seeds, n_real

    def _real_count(self, arr, total: int, n_real: int, R: int,
                    site: str) -> int:
        """Host count of True entries in ``arr``'s non-padding rows."""
        half = R // 2 if self.cfg.both_strands else R
        if (2 * n_real if self.cfg.both_strands else n_real) == R:
            return total
        c = arr[:n_real].sum()
        if self.cfg.both_strands:
            c = c + arr[half : half + n_real].sum()
        return _host_int(c, site)

    def phase2(self, state, times=None):
        reads, seeds, n_real = state
        cfg = self.cfg
        positions, segments = self.chunk_index(seeds)
        R = reads.shape[0]          # rows: 2*chunk when both_strands
        M, P = cfg.max_minis, cfg.max_pls
        occ_idx, occ_valid = seeds["occ_idx"], seeds["occ_valid"]
        mini_pos = seeds["mini_pos"]
        rows_real = 2 * n_real if cfg.both_strands else n_real

        n_valid = _host_int(seeds["n_valid"], "n_valid")
        lin_cap = bucket_capacity(n_valid, align=cfg.lin_block_r,
                                  cap_max=R * M * P)
        n_valid_real = self._real_count(occ_valid, n_valid, n_real, R,
                                        "n_valid_real")

        if cfg.engine == "fused":
            aff_cap = fused_affine_capacity(n_valid, R, cfg)
            with _span("fused", times):
                out = _fused_stage(segments, positions, reads, occ_idx,
                                   occ_valid, mini_pos, n_real, cfg, lin_cap,
                                   aff_cap)
                self._wait(reads)
            stats = dict(candidates_valid=n_valid_real,
                         linear_instances=lin_cap,
                         padded_linear_instances=rows_real * M * P,
                         survivors=out.pop("survivors"),
                         affine_dist_instances=aff_cap,
                         padded_affine_instances=rows_real * M,
                         affine_dirs_instances=(
                             n_real if cfg.cigar_mode == "eager" else 0))
            if cfg.both_strands:
                stats["reverse_best"] = out.pop("reverse_best")
            return out, stats, n_real

        with _span("linear", times):
            lin_end, best_pl, pass_filter, n_cand = _linear_stage(
                segments, reads, occ_idx, occ_valid, mini_pos, cfg, lin_cap)
            self._wait(reads)

        n_surv = _host_int(pass_filter.sum(), "survivors")
        n_surv_real = self._real_count(pass_filter, n_surv, n_real, R,
                                       "survivors_real")
        aff_cap = bucket_capacity(n_surv, align=cfg.aff_block_r,
                                  cap_max=R * M)
        with _span("affine", times):
            (best_aff, mapped, position, best_m, distance2, occ_w,
             mpos_w) = _affine_stage(segments, positions, reads, occ_idx,
                                     mini_pos, best_pl, pass_filter,
                                     lin_end, cfg, aff_cap)
            reads_w, strand, reverse_best = reads, None, None
            if cfg.both_strands:
                fold = _strand_stage(best_aff, mapped, position, distance2,
                                     n_cand, occ_w, mpos_w, reads, lin_end,
                                     n_real)
                best_aff, mapped, position = (fold["distance"],
                                              fold["mapped"],
                                              fold["position"])
                distance2, n_cand = fold["distance2"], fold["n_candidates"]
                occ_w, mpos_w, reads_w = (fold["occ_w"], fold["mpos_w"],
                                          fold["reads_w"])
                lin_end, strand = fold["linear_dist"], fold["strand"]
                reverse_best = fold["reverse_best"]
            self._wait(reads)

        out = dict(position=position, distance=best_aff,
                   distance2=distance2, mapped=mapped, linear_dist=lin_end,
                   n_candidates=n_cand)
        if strand is not None:
            out["strand"] = strand
        with _span("traceback", times):
            if cfg.cigar_mode == "eager":
                out["ops"], out["op_count"] = _winner_traceback(
                    segments, reads_w, occ_w, mpos_w, mapped, cfg)
                self._wait(reads)
            elif cfg.cigar_mode == "lazy":
                out.update(_tb_reads=reads_w, _tb_occ=occ_w, _tb_mpos=mpos_w)

        stats = dict(candidates_valid=n_valid_real,
                     linear_instances=lin_cap,
                     padded_linear_instances=rows_real * M * P,
                     survivors=n_surv_real,
                     affine_dist_instances=aff_cap,
                     padded_affine_instances=rows_real * M,
                     affine_dirs_instances=(
                         n_real if cfg.cigar_mode == "eager" else 0))
        if reverse_best is not None:
            stats["reverse_best"] = reverse_best
        return out, stats, n_real

    def fetch(self, state, times=None, *, into: _CallArrays):
        """The chunk's real rows of each output straight into its rows of
        the call's result arrays (``into``), and its count tensors (the
        fused engine's survivors, the strand fold's ``reverse_best``) to
        the host, in one ``d2h`` span on the fetch thread; ``placed`` is
        the bytes written into the result arrays.  Returns the chunk's
        stats."""
        out, stats, n_real = state
        with _span("d2h", times) as sp:
            placed = into.place(out, n_real)
            counts = {k: v.cpu() for k, v in stats.items()
                      if isinstance(v, torch.Tensor)}
            if sp is not None:
                _copy_args(sp, [*placed, *counts.values()])
                sp.set(placed=sum(t.nbytes for t in placed))
            stats = {**stats, **{k: int(v) for k, v in counts.items()}}
        return stats


def _merge_stats(parts: list[dict]) -> dict:
    out = {k: sum(p[k] for p in parts) for k in parts[0]}
    out["pruning_ratio"] = (
        1.0 - out["survivors"] / max(out["candidates_valid"], 1))
    out["n_chunks"] = len(parts)
    return out


def map_reads(index: GenomeIndex, reads: np.ndarray,
              cfg: MapperConfig | None = None, *,
              device=None) -> MappingResult:
    """Host-friendly wrapper: numpy index + reads -> MappingResult.

    .. deprecated::
        Use :class:`repro_torch.core.mapper.Mapper` —
        ``Mapper(index, cfg, device=device).map(reads)`` is the
        bit-identical replacement and keeps the index placed on the
        device across calls (this shim builds a fresh one-shot session
        each time).
    """
    warnings.warn(
        "map_reads is deprecated; use repro_torch.core.mapper.Mapper — "
        "Mapper(index, cfg).map(reads) is the bit-identical replacement "
        "(and reuses device placement across calls)",
        DeprecationWarning, stacklevel=2)
    from .mapper import Mapper
    return Mapper(index, cfg, device=device).map(reads)


def oracle_map(ref: np.ndarray, reads: np.ndarray, eth: int = 6,
               chunk: int = 4096, *, device=None):
    """Exhaustive banded-WF scan over every reference position (BWA-MEM
    stand-in ground truth for accuracy tests).  O(G * R) — small inputs
    only.  Runs the plain ``banded_wf`` on ``device`` (the card unless
    asked otherwise).

    Returns ``(best_p, best_d)``: per-read best position (ties ->
    leftmost) and its banded-WF distance, each (R,) int64.
    """
    dev = resolve_device(device)
    reads = np.asarray(reads, dtype=np.uint8)
    R, rl = reads.shape
    G = len(ref)
    pad = np.full(G + 2 * eth + rl, 4, dtype=np.uint8)
    pad[eth : eth + G] = ref
    n_pos = G - rl + 1
    best_d = np.full(R, 10 ** 9, dtype=np.int64)
    best_p = np.full(R, -1, dtype=np.int64)
    win = rl + 2 * eth
    view = np.lib.stride_tricks.sliding_window_view(pad, win)
    s1 = torch.from_numpy(reads).to(dev)
    for c0 in range(0, n_pos, chunk):
        c1 = min(c0 + chunk, n_pos)
        wins = torch.from_numpy(np.ascontiguousarray(view[c0:c1])).to(dev)
        C = c1 - c0
        d_end, _ = banded_wf(s1[:, None, :].expand(R, C, rl),
                             wins[None].expand(R, C, win), eth=eth)
        d = d_end.cpu().numpy()
        m = d.argmin(axis=1)
        dm = d[np.arange(R), m]
        better = dm < best_d
        best_d[better] = dm[better]
        best_p[better] = c0 + m[better]
    return best_p, best_d
