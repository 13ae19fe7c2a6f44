"""The benchmark's data: a synthetic reference and Illumina-like reads.

``make_reference`` draws the reference on the device: a uniform random
sequence with a fraction of it overwritten by exact copies of other
segments (the model of ``repro_torch.data.genome.make_reference``, drawn
here in a few tensor calls so that the yardstick does not move with the
program).

``sample_reads`` and ``sample_pairs`` draw reads with the per-base error
process of ``repro_torch.data.genome`` (substitution, insertion, deletion at
Illumina-like rates), vectorised over a whole pool in a few tensor calls on
the device that holds the reference, from a ``torch.Generator`` seeded by
the run.  A read is cut from a fixed number of error-process steps
(``read_len + STEP_SLACK``): the rare read that would need more deletions
than the slack has its surplus deletions read as matches, so every read has
exactly ``read_len`` bases.
"""
from __future__ import annotations

import dataclasses

import torch

# error-process steps past read_len that a read may spend on deletions
STEP_SLACK = 24
# event codes of the error process
MATCH, SUB, INS, DEL = 0, 1, 2, 3


def make_reference(length: int, seed: int, repeat_frac: float,
                   repeat_len: int, device) -> torch.Tensor:
    """``length`` random bases 0..3 on ``device`` with ``repeat_frac`` of
    them overwritten by exact copies of ``repeat_len``-base segments taken
    from elsewhere (segmental duplications).  Every copy reads the bases
    as first drawn; where copies overlap, the later one wins.  Drawn in a
    few tensor calls from a generator on the device seeded by ``seed``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    ref = torch.randint(0, 4, (length,), generator=g, device=dev,
                        dtype=torch.uint8)
    n_rep = int(length * repeat_frac / max(repeat_len, 1))
    if n_rep == 0:
        return ref
    src = torch.randint(0, length - repeat_len, (n_rep,), generator=g,
                        device=dev)
    dst = torch.randint(0, length - repeat_len, (n_rep,), generator=g,
                        device=dev)
    # the copy that owns each overwritten base: the last one covering it
    span = torch.arange(repeat_len, device=dev)
    owner = torch.full((length,), -1, dtype=torch.int32, device=dev)
    owner.scatter_reduce_(
        0, (dst[:, None] + span).reshape(-1),
        torch.arange(n_rep, device=dev, dtype=torch.int32).repeat_interleave(
            repeat_len),
        reduce="amax")
    at = torch.nonzero(owner >= 0).squeeze(1)
    o = owner[at].to(torch.int64)
    out = ref.clone()
    out[at] = ref[src[o] + (at - dst[o])]
    return out


def generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for one named stream of one run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B1 + stream) % (1 << 63))
    return g


def revcomp(reads: torch.Tensor) -> torch.Tensor:
    """Reverse complement of base codes 0..3 along the last axis."""
    return (3 - reads).flip(-1)


@dataclasses.dataclass
class Reads:
    reads: torch.Tensor      # (R, read_len) uint8, as sequenced
    start: torch.Tensor      # (R,) int64 forward-reference origin
    n_errors: torch.Tensor   # (R,) int64 edits in the read
    events: torch.Tensor     # (4,) int64 steps of each kind used


def _cut(ref: torch.Tensor, start: torch.Tensor, read_len: int,
         rates: dict, g: torch.Generator) -> Reads:
    """Reads whose first base is ``ref[start]``, under the error process."""
    dev = ref.device
    n = start.shape[0]
    steps = read_len + STEP_SLACK
    u = torch.rand((n, steps), generator=g, device=dev)
    p_sub, p_ins, p_del = rates["sub"], rates["ins"], rates["del"]
    ev = torch.full((n, steps), MATCH, dtype=torch.int8, device=dev)
    ev[u < p_sub + p_ins + p_del] = DEL
    ev[u < p_sub + p_ins] = INS
    ev[u < p_sub] = SUB
    emit = ev != DEL
    short = emit.sum(dim=1) < read_len
    if bool(short.any()):
        ev[short[:, None] & (ev == DEL)] = MATCH
        emit = ev != DEL
    adv = (ev != INS).to(torch.int64)
    off = torch.cumsum(adv, dim=1) - adv
    refb = ref[start[:, None] + off]
    shift = torch.randint(1, 4, (n, steps), generator=g, device=dev,
                          dtype=torch.uint8)
    rand_b = torch.randint(0, 4, (n, steps), generator=g, device=dev,
                           dtype=torch.uint8)
    base = torch.where(ev == SUB, (refb + shift) % 4,
                       torch.where(ev == INS, rand_b, refb))
    k = torch.cumsum(emit.to(torch.int64), dim=1) - 1
    keep = emit & (k < read_len)
    rows = torch.arange(n, device=dev)[:, None].expand(n, steps)
    reads = torch.empty((n, read_len), dtype=torch.uint8, device=dev)
    reads[rows[keep], k[keep]] = base[keep]
    # the steps a read used: up to and including its last emitted base
    last = torch.argmax((emit & (k == read_len - 1)).to(torch.int8), dim=1)
    used = torch.arange(steps, device=dev)[None, :] <= last[:, None]
    err = used & (ev != MATCH)
    events = torch.stack([(used & (ev == c)).sum() for c in
                          (MATCH, SUB, INS, DEL)])
    return Reads(reads=reads, start=start, n_errors=err.sum(dim=1),
                 events=events)


def sample_reads(ref: torch.Tensor, n: int, read_len: int, rates: dict,
                 revcomp_frac: float, foreign_frac: float,
                 g: torch.Generator) -> Reads:
    """``n`` single-end reads: origins uniform over the reference, the
    error process, a ``revcomp_frac`` share sequenced from the reverse
    strand, and a ``foreign_frac`` share replaced by random sequence (a
    foreign read's ``start`` is -1)."""
    dev = ref.device
    G = ref.shape[0]
    start = torch.randint(0, G - read_len - STEP_SLACK, (n,), generator=g,
                          device=dev)
    out = _cut(ref, start, read_len, rates, g)
    flip = torch.rand(n, generator=g, device=dev) < revcomp_frac
    out.reads[flip] = revcomp(out.reads[flip])
    foreign = torch.rand(n, generator=g, device=dev) < foreign_frac
    out.reads[foreign] = torch.randint(
        0, 4, (int(foreign.sum()), read_len), generator=g, device=dev,
        dtype=torch.uint8)
    out.start = torch.where(foreign, -1, start)
    return out


@dataclasses.dataclass
class Pairs:
    reads1: torch.Tensor     # (N, read_len) uint8
    reads2: torch.Tensor
    pos1: torch.Tensor       # (N,) forward-reference leftmost of R1
    pos2: torch.Tensor
    isize: torch.Tensor      # (N,) fragment length
    foreign2: torch.Tensor   # (N,) bool: R2 replaced by random sequence


def sample_pairs(ref: torch.Tensor, n: int, read_len: int, rates: dict,
                 insert_mean: float, insert_sd: float, r2_foreign_frac: float,
                 g: torch.Generator) -> Pairs:
    """``n`` FR pairs: fragment lengths normal, rounded and clipped to
    ``[read_len, 2 * insert_mean]`` as ``repro_torch.data.genome.
    sample_pairs`` clips them; the upstream mate forward, the downstream
    mate reverse-complemented; a coin flip makes either one R1; an
    ``r2_foreign_frac`` share of R2 mates replaced by random sequence."""
    dev = ref.device
    G = ref.shape[0]
    isize = torch.clamp(torch.round(
        torch.randn(n, generator=g, device=dev) * insert_sd + insert_mean),
        read_len, 2 * insert_mean).to(torch.int64)
    room = G - isize - read_len - STEP_SLACK
    lo = (torch.rand(n, generator=g, device=dev, dtype=torch.float64)
          * room).to(torch.int64)
    hi = lo + isize - read_len
    up = _cut(ref, lo, read_len, rates, g).reads
    dn = revcomp(_cut(ref, hi, read_len, rates, g).reads)
    r1_up = torch.rand(n, generator=g, device=dev) < 0.5
    reads1 = torch.where(r1_up[:, None], up, dn)
    reads2 = torch.where(r1_up[:, None], dn, up)
    foreign = torch.rand(n, generator=g, device=dev) < r2_foreign_frac
    reads2[foreign] = torch.randint(
        0, 4, (int(foreign.sum()), read_len), generator=g, device=dev,
        dtype=torch.uint8)
    return Pairs(reads1=reads1, reads2=reads2,
                 pos1=torch.where(r1_up, lo, hi),
                 pos2=torch.where(r1_up, hi, lo), isize=isize,
                 foreign2=foreign)
