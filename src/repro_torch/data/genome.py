"""Synthetic genome + Illumina-like read simulator (ground truth attached)
— a copy of ``repro.data.genome``'s single-end part, so the same seed
gives the same reference and the same reads in both packages — and the
FASTA/FASTQ writers that are the round-trip partners of ``repro_torch.io``.

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

from ..core.encoding import decode_to_str, revcomp


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


# --------------------------------------------------------------------------
# Standard-format writers (round-trip partners of repro_torch.io's parsers)
# --------------------------------------------------------------------------

def write_fasta(path_or_handle, contigs, width: int = 70) -> None:
    """Write contigs as FASTA.

    ``contigs`` is a single codes array (one record named ``ref``) or a
    list of ``(name, codes)`` pairs.  Lines wrap at ``width`` bases.
    """
    from ..io.fasta import _open
    if isinstance(contigs, np.ndarray):
        contigs = [("ref", contigs)]
    f, owned = _open(path_or_handle, "w")
    try:
        for name, codes in contigs:
            f.write(f">{name}\n")
            line = decode_to_str(codes)
            for i in range(0, len(line), width):
                f.write(line[i : i + width] + "\n")
    finally:
        if owned:
            f.close()


def write_fastq(path_or_handle, reads, quals: np.ndarray | None = None,
                names: list[str] | None = None) -> None:
    """Write reads as 4-line FASTQ records (gzip-transparent: a path
    ending in ``.gz`` writes a compressed stream).

    ``reads`` is a ``ReadSet`` (qualities taken from it) or an
    ``(R, rl)`` codes array.  Missing qualities default to ``I``
    (phred 40); missing names to ``read<i>``.
    """
    from ..io.fasta import _open
    if isinstance(reads, ReadSet):
        quals = reads.quals if quals is None else quals
        reads = reads.reads
    reads = np.asarray(reads)
    if quals is None:
        quals = np.full(reads.shape, ord("I"), dtype=np.uint8)
    f, owned = _open(path_or_handle, "w")
    try:
        for i in range(len(reads)):
            name = names[i] if names is not None else f"read{i}"
            f.write(f"@{name}\n{decode_to_str(reads[i])}\n+\n"
                    f"{np.asarray(quals[i]).tobytes().decode('ascii')}\n")
    finally:
        if owned:
            f.close()
