"""Synthetic genome + Illumina-like read simulator (ground truth attached)
— a copy of ``repro.data.genome``'s single-end part, so the same seed
gives the same reference and the same reads in both packages.

A uniform-random reference (optionally with repeated segments, which
exercise high-frequency minimizers) and reads sampled with
substitution/insertion/deletion errors at Illumina-like rates; every read
carries its true origin.  ``sample_reads(both_strands=True)``
reverse-complements a coin-flip subset after sampling, on a separate RNG
stream; ``true_pos`` is always the forward-reference leftmost position.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.encoding import revcomp


@dataclasses.dataclass(frozen=True)
class ReadSet:
    reads: np.ndarray        # (R, rl) uint8 base codes (as sequenced)
    true_pos: np.ndarray     # (R,) int32 forward-ref origin position
    n_errors: np.ndarray     # (R,) int32 number of simulated edits
    strand: np.ndarray | None = None  # (R,) int8 0=fwd 1=revcomp sampled
    quals: np.ndarray | None = None   # (R, rl) uint8 phred+33 ASCII


def make_reference(length: int, seed: int = 0, repeat_frac: float = 0.05,
                   repeat_len: int = 500) -> np.ndarray:
    """Random reference with a fraction of duplicated segments.

    Duplications create repetitive minimizers — the workload feature that
    motivates DART-PIM's Reads-FIFO caps and the RISC-V lowTh offload.
    """
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, length).astype(np.uint8)
    n_rep = int(length * repeat_frac / max(repeat_len, 1))
    for _ in range(n_rep):
        src = int(rng.integers(0, length - repeat_len))
        dst = int(rng.integers(0, length - repeat_len))
        ref[dst : dst + repeat_len] = ref[src : src + repeat_len]
    return ref


def sample_reads(ref: np.ndarray, n_reads: int, read_len: int = 150,
                 sub_rate: float = 0.002, ins_rate: float = 0.0005,
                 del_rate: float = 0.0005, seed: int = 1,
                 both_strands: bool = False) -> ReadSet:
    """Sample reads uniformly; apply per-base edit errors.

    Rates default to Illumina-like (~0.3% total), well inside eth=6 for
    rl=150 so the banded WF is exact for typical reads.

    ``both_strands=True`` reverse-complements a ~50% coin-flip subset
    (separate RNG stream: the sampled loci and errors are identical to
    the forward-only run, only the sequenced orientation flips).
    Simulated phred+33 qualities are attached either way.
    """
    rng = np.random.default_rng(seed)
    G = len(ref)
    margin = read_len + 16  # room for deletions consuming extra ref bases
    pos = rng.integers(0, G - margin, n_reads).astype(np.int32)
    reads = np.empty((n_reads, read_len), dtype=np.uint8)
    n_err = np.zeros(n_reads, dtype=np.int32)
    for r in range(n_reads):
        out, p, errs = [], int(pos[r]), 0
        while len(out) < read_len:
            u = rng.random()
            if u < sub_rate:
                out.append((ref[p] + int(rng.integers(1, 4))) % 4)
                p += 1
                errs += 1
            elif u < sub_rate + ins_rate:
                out.append(int(rng.integers(0, 4)))
                errs += 1
            elif u < sub_rate + ins_rate + del_rate:
                p += 1
                errs += 1
            else:
                out.append(ref[p])
                p += 1
        reads[r] = np.array(out[:read_len], dtype=np.uint8)
        n_err[r] = errs
    strand = np.zeros(n_reads, dtype=np.int8)
    if both_strands:
        srng = np.random.default_rng(seed + 0x5A5A)
        strand = (srng.random(n_reads) < 0.5).astype(np.int8)
        flip = strand == 1
        reads[flip] = revcomp(reads[flip])
    qrng = np.random.default_rng(seed + 0x9E37)
    quals = (qrng.integers(30, 41, (n_reads, read_len)) + 33).astype(np.uint8)
    return ReadSet(reads=reads, true_pos=pos, n_errors=n_err, strand=strand,
                   quals=quals)
