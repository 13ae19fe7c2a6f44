"""Synthetic genome + Illumina-like read simulator (ground truth attached)
— a copy of ``repro.data.genome``'s simulators, so the same seed gives
the same reference, reads and pairs in both packages — and the
FASTA/FASTQ writers that are the round-trip partners of ``repro_torch.io``.

A uniform-random reference (optionally with repeated segments, which
exercise high-frequency minimizers) and reads sampled with
substitution/insertion/deletion errors at Illumina-like rates; every read
carries its true origin.  ``sample_reads(both_strands=True)``
reverse-complements a coin-flip subset after sampling, on a separate RNG
stream; ``true_pos`` is always the forward-reference leftmost position.
``sample_pairs`` draws FR paired-end fragments on the RNG streams of
``repro.data.genome.sample_pairs`` (``seed``, ``seed + 0x7777`` for junk
mates, ``seed + 0x9E37`` for qualities).
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


@dataclasses.dataclass(frozen=True)
class PairedReadSet:
    """Simulated paired-end reads with full ground truth attached.

    FR library geometry: each fragment of length ``isize`` yields an R1
    from one end and an R2 from the other, facing inward; ``flip`` says
    which physical end became R1 (coin flip, like a real prep), so R1 is
    forward for ~half the pairs and reverse for the rest.  ``pos1``/
    ``pos2`` are forward-reference leftmost positions — exactly what the
    mapper reports for either strand — and ``isize`` is the true
    fragment length TLEN should recover.
    """
    reads1: np.ndarray       # (N, rl) uint8 as-sequenced R1 codes
    reads2: np.ndarray       # (N, rl) uint8 as-sequenced R2 codes
    pos1: np.ndarray         # (N,) int32 forward-ref leftmost of R1
    pos2: np.ndarray         # (N,) int32 forward-ref leftmost of R2
    strand1: np.ndarray      # (N,) int8 0=fwd 1=revcomp
    strand2: np.ndarray      # (N,) int8
    isize: np.ndarray        # (N,) int32 true fragment length
    n_errors1: np.ndarray    # (N,) int32
    n_errors2: np.ndarray    # (N,) int32
    quals1: np.ndarray       # (N, rl) uint8 phred+33 ASCII
    quals2: np.ndarray       # (N, rl) uint8


def _read_with_errors(rng, ref, start: int, read_len: int, sub_rate: float,
                      ins_rate: float, del_rate: float):
    """One error-laden read sampled forward from ``ref[start:]`` — the
    same per-base edit process as ``sample_reads`` (kept separate so the
    single-end RNG stream stays bit-identical to the historical one)."""
    out, p, errs = [], int(start), 0
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
    return np.array(out[:read_len], dtype=np.uint8), errs


def sample_pairs(ref: np.ndarray, n_pairs: int, read_len: int = 150,
                 insert_mean: float = 350.0, insert_sd: float = 30.0,
                 sub_rate: float = 0.002, ins_rate: float = 0.0005,
                 del_rate: float = 0.0005, unmappable_frac: float = 0.0,
                 seed: int = 1) -> PairedReadSet:
    """Sample FR paired-end fragments with ground-truth insert sizes.

    Fragment starts are uniform; lengths are normal
    (``insert_mean``/``insert_sd``), clipped to ``[read_len, 2*mean]``.
    The upstream mate is sequenced forward, the downstream mate
    reverse-complement (facing inward), and a coin flip decides which is
    R1 — so both ``(strand1, strand2)`` orientations occur, as in a real
    library.  ``unmappable_frac`` replaces that fraction of R2 mates
    with random sequence (simulated adapter/contaminant), the workload
    for mate rescue and the 0x8 FLAG path.
    """
    rng = np.random.default_rng(seed)
    G = len(ref)
    margin = read_len + 16
    isize = np.clip(np.round(rng.normal(insert_mean, insert_sd, n_pairs)),
                    read_len, 2 * insert_mean).astype(np.int32)
    starts = np.array([rng.integers(0, max(G - int(sz) - margin, 1))
                       for sz in isize], dtype=np.int32)
    r1 = np.empty((n_pairs, read_len), dtype=np.uint8)
    r2 = np.empty((n_pairs, read_len), dtype=np.uint8)
    e1 = np.zeros(n_pairs, dtype=np.int32)
    e2 = np.zeros(n_pairs, dtype=np.int32)
    pos1 = np.empty(n_pairs, dtype=np.int32)
    pos2 = np.empty(n_pairs, dtype=np.int32)
    s1 = np.empty(n_pairs, dtype=np.int8)
    s2 = np.empty(n_pairs, dtype=np.int8)
    for i in range(n_pairs):
        frag_lo = int(starts[i])
        frag_hi = frag_lo + int(isize[i]) - read_len  # downstream mate start
        up, ne_up = _read_with_errors(rng, ref, frag_lo, read_len,
                                      sub_rate, ins_rate, del_rate)
        dn_f, ne_dn = _read_with_errors(rng, ref, frag_hi, read_len,
                                        sub_rate, ins_rate, del_rate)
        dn = revcomp(dn_f)  # downstream mate is sequenced inward
        if rng.random() < 0.5:  # R1 = upstream (forward) mate
            r1[i], r2[i] = up, dn
            pos1[i], pos2[i] = frag_lo, frag_hi
            s1[i], s2[i] = 0, 1
            e1[i], e2[i] = ne_up, ne_dn
        else:                   # R1 = downstream (reverse) mate
            r1[i], r2[i] = dn, up
            pos1[i], pos2[i] = frag_hi, frag_lo
            s1[i], s2[i] = 1, 0
            e1[i], e2[i] = ne_dn, ne_up
    if unmappable_frac > 0:
        urng = np.random.default_rng(seed + 0x7777)
        junk = urng.random(n_pairs) < unmappable_frac
        r2[junk] = urng.integers(0, 4, (int(junk.sum()),
                                        read_len)).astype(np.uint8)
    qrng = np.random.default_rng(seed + 0x9E37)
    quals1 = (qrng.integers(30, 41, (n_pairs, read_len)) + 33
              ).astype(np.uint8)
    quals2 = (qrng.integers(30, 41, (n_pairs, read_len)) + 33
              ).astype(np.uint8)
    return PairedReadSet(reads1=r1, reads2=r2, pos1=pos1, pos2=pos2,
                         strand1=s1, strand2=s2, isize=isize,
                         n_errors1=e1, n_errors2=e2,
                         quals1=quals1, quals2=quals2)


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


def write_fastq_pair(path1, path2, pairs: "PairedReadSet",
                     names: list[str] | None = None,
                     interleaved_path=None) -> None:
    """Write a ``PairedReadSet`` as R1/R2 FASTQ files (gzip when the
    paths end in ``.gz``), mate names suffixed ``/1``/``/2``.  Pass
    ``interleaved_path`` instead of ``path1``/``path2`` (set those to
    None) for the single-file interleaved layout."""
    base = (names if names is not None
            else [f"pair{i}" for i in range(len(pairs.reads1))])
    n1 = [f"{b}/1" for b in base]
    n2 = [f"{b}/2" for b in base]
    if interleaved_path is not None:
        from ..io.fasta import _open
        f, owned = _open(interleaved_path, "w")
        try:
            for i in range(len(base)):
                for nm, rd, ql in ((n1[i], pairs.reads1[i], pairs.quals1[i]),
                                   (n2[i], pairs.reads2[i],
                                    pairs.quals2[i])):
                    f.write(f"@{nm}\n{decode_to_str(rd)}\n+\n"
                            f"{np.asarray(ql).tobytes().decode('ascii')}\n")
        finally:
            if owned:
                f.close()
        return
    write_fastq(path1, pairs.reads1, pairs.quals1, n1)
    write_fastq(path2, pairs.reads2, pairs.quals2, n2)


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
