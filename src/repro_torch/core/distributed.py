"""Distributed read mapping (the paper's Sec. V architecture) — torch twin
of ``repro.core.distributed``.

DART-PIM's controller hierarchy routes each read to the crossbars owning
its minimizers; results flow back to the main RISC-V for the final
min-reduce.  Over a ``ShardMesh`` this is:

  stage A (read owner) : minimizer extraction (the minimizer kernel on
                         ``wf_backend="cuda"``), destination =
                         hash % n_shards, bucketing into fixed-capacity
                         send buffers
  exchange             : one all_to_all sends every entry to the shard
                         that owns its minimizer
  stage B (index owner): local lookup -> banded linear WF on the valid
                         (entry, placement) slots -> min-extract -> filter
                         -> banded affine WF on each shard's compacted
                         survivors (static capacity from
                         ``stage_b_affine_capacity``, overflow dropped)
  exchange (return)    : (distance, position, co-optimal estimate) back to
                         the owner
  stage C (read owner) : scatter-min per read (main-RISC-V reduce)

Fixed buffer capacities are the Reads-FIFO/maxReads mechanism: overflow
entries are *dropped*, trading accuracy for bounded latency.

A ``ShardMesh`` holds ``n_shards`` logical shards and an exchange whose
``all_to_all(x)`` takes ``x`` of shape ``(S_local, S, cap, ...)`` and
returns the same shape, ``[i][j]`` being what shard ``j`` sent to local
shard ``i``.  The local form (every shard on one device) exchanges by a
transpose in device memory; the group form (one shard per rank of a
``torch.distributed`` process group) by ``all_to_all_single``.  Both run
the same stage code, batched over the shards a process holds.

The index is sharded by minimizer hash (``shard_index``) — DART-PIM's
"crossbar per minimizer" data organization, with the same deliberate
segment duplication.  The public front-end is
``repro_torch.core.mapper.Mapper`` with ``topology="mesh"``
(``distributed_map_reads`` is its deprecation shim).
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from . import wf_backend as wfb
from .compaction import bucket_capacity
from .device import resolve_device
from .filtering import collapse_candidates, gather_windows
from .index import GenomeIndex
from .minimizers import hash32, unique_read_minimizers
from .pipeline import MapperConfig

AXIS = "shards"
_INT32_MAX = 2**31 - 1
# stage C's "no position" key for the leftmost-tie reduce (positions are
# int64 here; the reference's int32 program uses 2**30)
_POS_BIG = torch.iinfo(torch.int64).max


def stage_b_affine_capacity(n_entries: int, cfg: MapperConfig,
                            frac: float | None = None) -> int:
    """Static survivor capacity for stage B's affine pass, per shard.

    Each of the ``n_entries`` bucket slots contributes at most one affine
    candidate (its best of ``max_pls`` placements); ``frac`` is the
    provisioned fraction of that bound (default
    ``cfg.stage_b_survivor_frac``; ``stage_b_adaptive`` sessions pass the
    quantile of their observed survivor history, ``Mapper._stage_b_frac``).
    A threshold that cannot reject anything (``> eth``) disables the
    filter, so provisioning falls back to full capacity.  Never more than
    ``n_entries``.
    """
    if frac is None:
        frac = cfg.stage_b_survivor_frac
    frac = 1.0 if cfg.filter_threshold > cfg.eth else \
        max(min(frac, 1.0), 0.0)
    want = int(np.ceil(n_entries * frac))
    cap = bucket_capacity(want, align=cfg.aff_block_r, cap_max=n_entries)
    return min(cap, n_entries)


# ------------------------------------------------------------------ the mesh

class LocalExchange:
    """Every shard on one device: what shard ``j`` bucketed for shard
    ``i`` is row ``j`` of shard ``i``'s receive buffer after a transpose
    in device memory."""
    group = None

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(0, 1)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x


class GroupExchange:
    """One shard per rank of a ``torch.distributed`` process group:
    ``all_to_all_single`` with equal splits (NCCL takes CUDA tensors,
    gloo CPU tensors; a backend that does not take the tensor raises)."""

    def __init__(self, group):
        self.group = group

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        if x.shape[0] != 1:
            raise ValueError(f"the group form holds one shard per rank; got "
                             f"{x.shape[0]} local shards")
        send = x[0].contiguous()
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=self.group)
        return out[None]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate every rank's ``x`` along dim 0, in rank order."""
        import torch.distributed as dist
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts)


@dataclasses.dataclass(eq=False)
class ShardMesh:
    """The port's flat shard mesh (``jax.sharding.Mesh`` with one axis):
    ``n_shards`` logical shards, the ones this process holds (``local``:
    all of them, or its rank's one), the ``device`` they live on and the
    ``exchange`` between them."""
    n_shards: int
    local: tuple
    device: torch.device
    exchange: object

    @property
    def group(self):
        return self.exchange.group

    def __repr__(self):
        form = "local" if self.group is None else "group"
        return (f"ShardMesh({AXIS}={self.n_shards}, {form} form, "
                f"local={list(self.local)}, device={self.device})")


def make_genomics_mesh(n_shards: int | None = None, *, device=None,
                       group=None) -> ShardMesh:
    """Flat shard mesh for the distributed read mapper (one axis;
    ``launch.mesh`` exports it).  ``n_shards=None`` means one shard per
    device the mesh spans.  Without ``group``: the local form, all shards
    on ``device`` (None: the CUDA card), so one by default.  With a
    ``torch.distributed`` ``group``: one shard per rank on ``device``,
    ``n_shards`` None or the group's size."""
    dev = resolve_device(device)
    if group is None:
        n = 1 if n_shards is None else int(n_shards)
        if n < 1:
            raise ValueError(f"n_shards={n_shards!r} must be >= 1")
        return ShardMesh(n, tuple(range(n)), dev, LocalExchange())
    import torch.distributed as dist
    world = dist.get_world_size(group)
    if n_shards is not None and n_shards != world:
        raise ValueError(f"n_shards={n_shards} but the process group has "
                         f"{world} ranks — the group form holds one shard "
                         f"per rank")
    return ShardMesh(world, (dist.get_rank(group),), dev,
                     GroupExchange(group))


# ------------------------------------------------------------ the index

@dataclasses.dataclass(frozen=True)
class ShardedIndex:
    """Per-shard padded CSR index arrays (leading axis = shard), the
    reference's dtypes."""
    uniq_kmers: np.ndarray   # (S, U) uint32, padded with 0xFFFFFFFF
    offsets: np.ndarray      # (S, U+1) int32
    positions: np.ndarray    # (S, O) int32
    segments: np.ndarray     # (S, O, seg_len) uint8
    n_shards: int
    read_len: int
    k: int
    w: int
    eth: int

    def device_arrays(self, device, shards=None) -> tuple:
        """The ``shards`` (default: all) placed on ``device``: uniq,
        offsets and positions as int64 (codes holding uint32 values),
        segments uint8, each with a leading local-shard axis."""
        sel = list(range(self.n_shards)) if shards is None else list(shards)
        return tuple(torch.as_tensor(np.ascontiguousarray(a[sel], dtype=dt),
                                     device=device)
                     for a, dt in ((self.uniq_kmers, np.int64),
                                   (self.offsets, np.int64),
                                   (self.positions, np.int64),
                                   (self.segments, np.uint8)))

    @classmethod
    def from_partitions(cls, parts, *, read_len: int, k: int, w: int,
                        eth: int, seg_len: int) -> "ShardedIndex":
        """Stack pre-partitioned per-shard CSRs into the padded layout.

        ``parts`` is a sequence of ``(kmers, offsets, positions,
        segments)`` tuples, one per shard, already assigned by the
        ``hash32(kmer) % n_shards`` crossbar rule (the partitions of an
        ``index.ShardedGenomeIndex``).  The padding conventions (uniq
        padded with 0xFFFFFFFF, offsets with the last offset) are
        ``shard_index``'s, so the stacked arrays equal sharding the
        equivalent flat index.
        """
        uq, of, po, sg = _padded_layout(
            [len(p[0]) for p in parts],
            [int(p[1][-1]) if len(p[0]) else 0 for p in parts],
            [len(p[2]) for p in parts], seg_len)
        for s, (kmers, offsets, positions, segments) in enumerate(parts):
            nu, no = len(kmers), len(positions)
            uq[s, :nu] = kmers
            of[s, : nu + 1] = offsets
            po[s, :no] = positions
            sg[s, :no] = segments
        return cls(uniq_kmers=uq, offsets=of, positions=po, segments=sg,
                   n_shards=len(parts), read_len=read_len, k=k, w=w,
                   eth=eth)


def _padded_layout(n_uniq, last_offset, n_occ, seg_len: int) -> tuple:
    """The padded per-shard arrays (uniq_kmers, offsets, positions,
    segments) for shards of ``n_uniq[s]`` unique k-mers and ``n_occ[s]``
    occurrence rows, with only the padding written: ``uniq_kmers`` past a
    shard's k-mers is 0xFFFFFFFF and ``offsets`` past its last k-mer holds
    ``last_offset[s]``; every capacity is at least 1."""
    n_shards = len(n_uniq)
    u_cap = max(max(n_uniq, default=0), 1)
    o_cap = max(max(n_occ, default=0), 1)
    uq = np.full((n_shards, u_cap), 0xFFFFFFFF, dtype=np.uint32)
    of = np.zeros((n_shards, u_cap + 1), dtype=np.int32)
    for s in range(n_shards):
        of[s, n_uniq[s] + 1:] = last_offset[s]
    po = np.zeros((n_shards, o_cap), dtype=np.int32)
    sg = np.zeros((n_shards, o_cap, seg_len), dtype=np.uint8)
    return uq, of, po, sg


def shard_index(index: GenomeIndex, n_shards: int) -> ShardedIndex:
    """Assign each unique minimizer to shard ``hash32(kmer) % n_shards``.

    One stable sort by shard instead of the reference's loop over every
    unique minimizer; the padded arrays equal the reference's byte for
    byte.  Positions are int32 on the mesh, as in the reference: an index
    past 2^31 is refused.
    """
    kmers = np.asarray(index.uniq_kmers).astype(np.uint32)
    offs = np.asarray(index.offsets).astype(np.int64)
    positions = np.asarray(index.positions)
    if len(positions) and int(positions.max()) > _INT32_MAX:
        raise ValueError(
            f"mesh shards hold int32 positions but this index reaches "
            f"position {int(positions.max())} (> {_INT32_MAX}); map "
            f"references past 2^31 bases on topology='single'")
    U = len(kmers)
    h = (hash32(torch.from_numpy(kmers.astype(np.int64))) % n_shards
         ).numpy()
    counts = np.diff(offs)
    per_u = np.bincount(h, minlength=n_shards)
    per_o = np.bincount(h, weights=counts,
                        minlength=n_shards).astype(np.int64)
    uq, of, po, sg = _padded_layout(per_u.tolist(), per_o.tolist(),
                                    per_o.tolist(), index.seg_len)
    order = np.argsort(h, kind="stable")      # by shard, k-mer order kept
    hs, cs = h[order], counts[order]
    u_start = np.concatenate([[0], np.cumsum(per_u)[:-1]])
    within_u = np.arange(U) - u_start[hs]
    uq[hs, within_u] = kmers[order]
    # each shard's CSR: running occurrence count within the shard
    cum = np.cumsum(cs)
    o_start = np.concatenate([[0], np.cumsum(per_o)[:-1]])
    of[hs, within_u + 1] = cum - o_start[hs]
    # each shard's occurrence rows, in its k-mers' order: shard s holds
    # rows[o_start[s]:o_start[s] + per_o[s]], gathered straight into place
    n_occ = int(cum[-1]) if U else 0
    if n_occ:
        rows = (np.repeat(offs[:-1][order] - (cum - cs), cs)
                + np.arange(n_occ, dtype=np.int64))
        segments = np.asarray(index.segments)
        for s in range(n_shards):
            mine = rows[o_start[s]:o_start[s] + int(per_o[s])]
            po[s, :len(mine)] = positions[mine]
            np.take(segments, mine, axis=0, out=sg[s, :len(mine)])
    return ShardedIndex(uniq_kmers=uq, offsets=of, positions=po, segments=sg,
                        n_shards=n_shards, read_len=index.read_len,
                        k=index.k, w=index.w, eth=index.eth)


# ------------------------------------------------------------ the stages

def _bucket_by_dst(dst, payload, n_shards: int, cap: int):
    """Scatter entries into (n_shards, cap) buckets; overflow dropped.

    The reference's ``_bucket_by_dst`` for each of L local shards at once:
    dst (L, E) target shard per entry (n_shards = drop), payload a dict of
    (L, E, ...) tensors -> a dict of (L, n_shards, cap, ...) tensors plus
    a ``valid`` mask, and the (L,) drop counts.  One stable sort by
    (local shard, dst) keeps each group's entries in their original order,
    as the reference's per-shard stable sort does."""
    L, E = dst.shape
    dev = dst.device
    key = (torch.arange(L, device=dev)[:, None] * (n_shards + 1)
           + dst).reshape(-1)
    order = torch.argsort(key, stable=True)
    ks = key[order]
    # rank within group: position - index of the group's first element
    rank = torch.arange(L * E, device=dev) - torch.searchsorted(ks, ks)
    ls, ds = ks // (n_shards + 1), ks % (n_shards + 1)
    sent = ds < n_shards
    ok = sent & (rank < cap)
    n_slots = L * n_shards * cap
    slot = torch.where(ok, (ls * n_shards + ds) * cap + rank, n_slots)
    out = {}
    for name, arr in payload.items():
        a = arr.reshape((L * E,) + tuple(arr.shape[2:]))[order]
        buf = torch.zeros((n_slots + 1,) + tuple(a.shape[1:]),
                          dtype=a.dtype, device=dev)
        buf[slot] = a                 # overflow all lands on the trash slot
        out[name] = buf[:-1].view((L, n_shards, cap) + tuple(a.shape[1:]))
    vmask = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
    vmask[slot] = ok
    out["valid"] = vmask[:-1].view(L, n_shards, cap)
    dropped = torch.bincount(ls[sent & ~ok], minlength=L)
    return out, dropped


def _stage_b(local, uniq, offsets, positions, segments, cfg: MapperConfig,
             aff_cap: int):
    """Index-owner compute for each local shard: lookup -> linear WF ->
    min -> filter -> compacted affine WF.

    ``local`` holds the received entries, each (L, E, ...): ``kmer``,
    ``minipos``, ``read`` (L, E, read_len) and ``valid``; the index
    tensors are the local shards' (L, ...) from
    ``ShardedIndex.device_arrays``.  The linear WF runs on the valid
    (entry, placement) slots of every local shard in one launch — an
    invalid slot's distance is the saturated ``eth + 1`` either way.  Each
    shard compacts its filter survivors, in entry order, into ``aff_cap``
    slots; survivors past that are *dropped* (reported unmapped), and the
    affine WF runs on the kept ones of every local shard in one launch.

    Returns (aff (L, E) int32, pos (L, E) int64, co_est (L, E) int32 — the
    placement-level co-optimal runner-up estimate for the distance2
    reduce —, n_survivors (L,), n_affine_dropped (L,)).
    """
    kmers, minipos = local["kmer"], local["minipos"]
    L, E = kmers.shape
    dev = kmers.device
    P, eth, sat = cfg.max_pls, cfg.eth, cfg.sat_affine
    sat_lin = eth + 1
    U, O = uniq.shape[1], positions.shape[1]
    reads = local["read"].reshape(L * E, cfg.read_len)
    seg_rows = segments.reshape(L * O, segments.shape[-1])
    pos_rows = positions.reshape(-1)
    mp_flat = minipos.reshape(-1)

    idx = torch.clamp(torch.searchsorted(uniq, kmers), max=U - 1)
    found = (uniq.gather(1, idx) == kmers) & local["valid"]
    start = offsets.gather(1, idx)
    count = offsets.gather(1, idx + 1) - start
    lanes = torch.arange(P, device=dev)
    occ_valid = (lanes < count[..., None]) & found[..., None]   # (L, E, P)

    # (3) linear WF on the valid slots only
    l_i, e_i, p_i = occ_valid.nonzero(as_tuple=True)
    g = l_i * E + e_i                        # flat entry of each slot
    row = l_i * O + start[l_i, e_i] + p_i    # its occurrence row
    mp = mp_flat[g]
    wins = gather_windows(seg_rows, row, mp, read_len=cfg.read_len,
                          k=cfg.k, eth=eth)
    de, _ = wfb.linear_wf_dist(reads[g], wins, eth=eth,
                               backend=cfg.wf_backend)
    de = de.to(torch.int32)
    del wins
    lin_end = torch.full((L * E, P), sat_lin, dtype=torch.int32, device=dev)
    lin_end[g, p_i] = de

    # (4) min extraction + filter; each shard's survivors in entry order
    best_pl, best_lin, passed = collapse_candidates(lin_end,
                                                    cfg.filter_threshold)
    del lin_end
    passed = passed.view(L, E)
    n_surv = passed.sum(dim=1)
    rank = torch.cumsum(passed.to(torch.int64), dim=1) - 1
    kept = passed & (rank < aff_cap)
    n_aff_drop = n_surv - kept.sum(dim=1)
    bp = best_pl.view(L, E)
    sel_occ = torch.where((bp < count) & found, start + bp, 0)
    pos = positions.gather(1, sel_occ) - minipos                # (L, E)

    # (5) distance-only affine on the kept survivors
    kg = kept.reshape(-1).nonzero().squeeze(1)
    krow = (kg // E) * O + sel_occ.reshape(-1)[kg]
    wins = gather_windows(seg_rows, krow, mp_flat[kg],
                          read_len=cfg.read_len, k=cfg.k, eth=eth)
    ae, _ = wfb.affine_wf_dist(reads[kg], wins, eth=eth, sat=sat,
                               backend=cfg.wf_backend)
    del wins
    aff_end = torch.full((L * E,), sat, dtype=torch.int32, device=dev)
    aff_end[kg] = ae.to(torch.int32)

    # placement-level co-optimal survey: far-locus placements at least as
    # good as the chosen one, their affine distance estimated as this
    # entry's plus the linear excess (pipeline._co_optimal_runner_up's
    # mesh analog, over the valid slots)
    pos_flat = pos.reshape(-1)
    far = (pos_rows[row] - mp - pos_flat[g]).abs() > eth
    co = far & (de <= min(cfg.filter_threshold, eth))
    min_far = torch.full((L * E,), sat_lin, dtype=torch.int32, device=dev)
    min_far.scatter_reduce_(0, g[co], de[co], "amin", include_self=True)
    kept_flat = kept.reshape(-1)
    co_est = torch.clamp(aff_end + torch.clamp(min_far - best_lin, min=0),
                         max=sat)
    co_est = torch.where((min_far < sat_lin) & kept_flat, co_est, sat)
    pos = torch.where(kept, pos, -1)
    return (aff_end.view(L, E), pos, co_est.view(L, E).to(torch.int32),
            n_surv, n_aff_drop)


def _stage_c(back_aff, back_pos, back_co, rid, valid, n_reads: int,
             cfg: MapperConfig):
    """Min-reduce per read over the returned entries (L, S, cap): the
    distance, the leftmost position among ties, and the runner-up at a
    different locus (beyond the band from the winner) folded with the
    co-optimal estimates.  ``rid``/``valid`` are the origin's own buckets
    (they are not sent back); ``n_reads`` counts the local shards' reads,
    ``rid`` indexing them."""
    sat, eth = cfg.sat_affine, cfg.eth
    dev = back_aff.device
    flat_aff = torch.where(valid, back_aff, sat).reshape(-1)
    flat_pos = back_pos.reshape(-1)
    flat_rid = torch.where(valid, rid, n_reads).reshape(-1)
    best = torch.full((n_reads + 1,), sat, dtype=torch.int32, device=dev)
    best.scatter_reduce_(0, flat_rid, flat_aff, "amin", include_self=True)
    is_best = (flat_aff == best[flat_rid]) & (flat_rid < n_reads)
    # leftmost position among ties
    bigpos = torch.where(is_best & (flat_pos >= 0), flat_pos, _POS_BIG)
    posr = torch.full((n_reads + 1,), _POS_BIG, dtype=torch.int64,
                      device=dev)
    posr.scatter_reduce_(0, flat_rid, bigpos, "amin", include_self=True)
    position = torch.where((best[:n_reads] < sat)
                           & (posr[:n_reads] < _POS_BIG), posr[:n_reads], -1)
    pos_ext = torch.cat([position, position.new_full((1,), -1)])
    far = (flat_pos - pos_ext[flat_rid]).abs() > eth
    d2_key = torch.where(far & (flat_aff < sat) & (flat_pos >= 0), flat_aff,
                         sat)
    best2 = torch.full((n_reads + 1,), sat, dtype=torch.int32, device=dev)
    best2.scatter_reduce_(0, flat_rid, d2_key, "amin", include_self=True)
    flat_co = torch.where(valid, back_co, sat).reshape(-1)
    best2.scatter_reduce_(0, flat_rid, flat_co, "amin", include_self=True)
    return position, best[:n_reads], best2[:n_reads]


def make_distributed_mapper(mesh: ShardMesh, cfg: MapperConfig,
                            n_shards: int, send_cap: int,
                            aff_cap: int | None = None):
    """The mesh mapping step over ``mesh``'s exchange.

    Returns ``(fn, stage_b_affine_cap)``; ``aff_cap`` overrides the
    negotiated per-shard survivor capacity (the ``Mapper`` session passes
    its plan's, possibly adaptively derived).  ``fn(uniq, offsets,
    positions, segments, reads)`` takes the local shards' index tensors
    (``ShardedIndex.device_arrays(device, mesh.local)``) and their reads,
    ``reads[i*R_local:(i+1)*R_local]`` for local shard i, on the mesh's
    device, and returns the whole batch's (position (R,) int64, distance
    (R,) int32, distance2 (R,) int32) with the per-shard (dropped,
    stage_b_survivors, stage_b_affine_dropped), each (n_shards,) int64 —
    gathered from every rank in the group form.
    """
    if mesh.n_shards != n_shards:
        raise ValueError(f"the mesh has {mesh.n_shards} shards, not "
                         f"{n_shards}")
    M = cfg.max_minis
    if aff_cap is None:
        # every shard's stage B sees n_shards*send_cap bucket entries
        aff_cap = stage_b_affine_capacity(n_shards * send_cap, cfg)
    ex = mesh.exchange
    L = len(mesh.local)

    def step(uniq, offsets, positions, segments, reads):
        R = reads.shape[0] // L           # reads per local shard
        dev = reads.device
        # ---- stage A: seeding + bucketing
        kmers, minipos, valid = unique_read_minimizers(
            reads, k=cfg.k, w=cfg.w, max_uniq=M, backend=cfg.wf_backend)
        dst = torch.where(valid, hash32(kmers) % n_shards, n_shards)
        rid = (torch.arange(R * M, device=dev) // M).expand(L, R * M)
        buckets, dropped = _bucket_by_dst(
            dst.view(L, R * M),
            {"kmer": kmers.view(L, R * M), "minipos": minipos.view(L, R * M),
             "rid": rid}, n_shards, send_cap)
        local_rows = (torch.arange(L, device=dev)[:, None, None] * R
                      + buckets["rid"])
        meta = torch.stack([buckets["kmer"], buckets["minipos"],
                            buckets["valid"].to(torch.int64)], dim=-1)
        read_b = reads[local_rows]                       # (L, S, cap, rl)

        # ---- exchange: entries travel to their minimizer's home shard
        recv = ex.all_to_all(meta).reshape(L, -1, 3)
        recv_read = ex.all_to_all(read_b)
        del read_b

        # ---- stage B on the index owner
        aff, pos, co_est, n_surv, aff_drop = _stage_b(
            {"kmer": recv[..., 0].contiguous(),
             "minipos": recv[..., 1].contiguous(),
             "valid": recv[..., 2].bool(), "read": recv_read},
            uniq, offsets, positions, segments, cfg, aff_cap)
        del recv_read
        rvalid = recv[..., 2].bool()
        aff = torch.where(rvalid, aff, cfg.sat_affine)
        co_est = torch.where(rvalid, co_est, cfg.sat_affine)

        # ---- return trip: the origin keeps its own rid/valid buckets
        back = ex.all_to_all(torch.stack(
            [aff.to(torch.int64), pos, co_est.to(torch.int64)],
            dim=-1).view(L, n_shards, send_cap, 3))

        # ---- stage C: min-reduce per read
        position, best, best2 = _stage_c(
            back[..., 0].to(torch.int32), back[..., 1],
            back[..., 2].to(torch.int32), local_rows, buckets["valid"],
            L * R, cfg)
        stats = torch.stack([dropped, n_surv, aff_drop], dim=1)  # (L, 3)
        position, best, best2 = (ex.all_gather(position),
                                 ex.all_gather(best), ex.all_gather(best2))
        stats = ex.all_gather(stats)
        return position, best, best2, stats[:, 0], stats[:, 1], stats[:, 2]

    return step, aff_cap


_LEGACY_STATS_KEYS = (
    "stage_b_entries", "stage_b_survivors", "stage_b_affine_capacity",
    "stage_b_affine_instances", "stage_b_padded_affine_instances",
    "stage_b_affine_dropped", "send_dropped")


def distributed_map_reads(mesh: ShardMesh, sidx: ShardedIndex,
                          reads: np.ndarray,
                          cfg: MapperConfig | None = None,
                          send_cap: int | None = None,
                          with_stats: bool = False):
    """Host wrapper: returns (positions, distances, dropped_per_shard),
    plus a stage-B stats dict when ``with_stats=True``.

    .. deprecated::
        Use :class:`repro_torch.core.mapper.Mapper` with
        ``topology="mesh"`` — ``Mapper(sidx, cfg, topology="mesh",
        mesh=mesh).map(reads)`` returns the same positions and distances.
    """
    warnings.warn(
        "distributed_map_reads is deprecated; use "
        "repro_torch.core.mapper.Mapper with topology=\"mesh\" — "
        "Mapper(sidx, cfg, topology=\"mesh\", mesh=mesh).map(reads) is the "
        "bit-identical replacement", DeprecationWarning, stacklevel=2)
    from .mapper import Mapper

    R, S = len(reads), sidx.n_shards
    if R % S:
        raise ValueError("pad reads to a multiple of the shard count")
    mapper = Mapper(sidx, cfg, topology="mesh", mesh=mesh,
                    send_cap=send_cap)
    res = mapper.map(reads)
    st = res.stats
    dropped = st["send_dropped_per_shard"]
    if not with_stats:
        if st.dropped_affine:  # bounded-latency drop, never a silent one
            warnings.warn(
                f"stage B dropped {st.dropped_affine} filter survivors on "
                f"affine-capacity overflow (capacity "
                f"{st['stage_b_affine_capacity']}/shard); raise "
                f"stage_b_survivor_frac or send_cap, or pass "
                f"with_stats=True to track this", stacklevel=2)
        return res.position, res.distance, dropped
    return (res.position, res.distance, dropped,
            {k: st[k] for k in _LEGACY_STATS_KEYS})
