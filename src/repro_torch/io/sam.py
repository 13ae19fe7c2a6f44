"""Spec-valid SAM emission + a dependency-free validator — a copy of
``repro.io.sam``.

Only what the mapper actually produces is emitted, precisely:

* FLAG uses 0x4 (unmapped) and 0x10 (reverse strand) on single-end
  records; paired records (``emit_paired_alignments``) add the pairing
  bits 0x1/0x2/0x8/0x20/0x40/0x80;
* POS is the 1-based, contig-local leftmost position (the mapper's
  global concatenated position goes through ``fasta.ReferenceMap``);
* CIGAR comes from the affine-WF traceback via ``cigar.cigar_from_ops``
  (``"*"`` without a traceback and on the ``max_ops`` truncation path);
* SEQ/QUAL are stored in *alignment* orientation per the SAM spec:
  reverse-strand hits store the reverse-complemented read and reversed
  qualities (exactly the orientation the engine aligned);
* NM:i carries the affine-WF distance — the paper's alignment cost
  (gap-open + gap-extend weighted), deliberately *not* the SAM spec's
  literal mismatch+gap-base count, and computed over the full traceback
  (including any edge deletions the CIGAR normalization trims).

``validate_sam`` is the boundary's test oracle: a small, dependency-free
checker (header shape, mandatory columns, FLAG/CIGAR/SEQ consistency,
and the pair checks of paired-end SAM), the same oracle as the
reference's.
"""
from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from ..core.encoding import decode_to_str, revcomp
from .cigar import (cigar_from_ops, cigar_query_len, cigar_ref_len,
                    parse_cigar, trim_edge_deletions, unparse_cigar)
from .fasta import Contig, ReferenceMap

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
MAPQ_UNAVAILABLE = 255   # single-end path: no mapping-quality model

# FLAG bits that are only meaningful on paired templates (spec 1.4)
_PAIRED_ONLY_FLAGS = (FLAG_PROPER | FLAG_MATE_UNMAPPED | FLAG_MATE_REVERSE
                      | FLAG_READ1 | FLAG_READ2)


def sam_header(contigs: list[Contig], *, program_id: str = "repro",
               program_name: str = "repro_torch.launch.map_fastq",
               command_line: str | None = None) -> list[str]:
    """@HD/@SQ/@PG header lines (unsorted output)."""
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    lines += [f"@SQ\tSN:{c.name}\tLN:{c.length}" for c in contigs]
    pg = f"@PG\tID:{program_id}\tPN:{program_name}"
    if command_line:
        pg += f"\tCL:{command_line}"
    return lines + [pg]


def sam_record(qname: str, flag: int, rname: str, pos: int, mapq: int,
               cigar: str, seq: str, qual: str, *, rnext: str = "*",
               pnext: int = 0, tlen: int = 0,
               nm: int | None = None) -> str:
    """One alignment line.  The single-end defaults keep RNEXT/PNEXT/TLEN
    at ``*``/0/0; the paired emitter passes real mate fields."""
    fields = [qname, str(flag), rname, str(pos), str(mapq), cigar,
              rnext, str(pnext), str(tlen), seq, qual]
    if nm is not None:
        fields.append(f"NM:i:{nm}")
    return "\t".join(fields)


def _qual_str(q: np.ndarray) -> str:
    return q.tobytes().decode("ascii")


# complement for raw sequence text; non-ACGT (N, IUPAC codes) self-map so
# the emitted SEQ never invents bases the input didn't have
_COMP_TABLE = str.maketrans("ACGTacgt", "TGCAtgca")


def _revcomp_str(seq: str) -> str:
    return seq.translate(_COMP_TABLE)[::-1]


def _mapped_fields(result, i: int, reads, quals, seqs,
                   refmap: ReferenceMap):
    """Placement + sequence fields of one *mapped* record: ``(contig,
    local_pos0, cigar, seq, qual_str, rev)``.  The single place where the
    edge-deletion CIGAR normalization, the post-shift contig resolution,
    and the alignment-orientation SEQ/QUAL flips happen — shared by the
    single-end and paired emitters so their records cannot drift."""
    strand = result.strand
    rev = bool(strand[i]) if strand is not None else False
    cig, shift = "*", 0
    if result.ops is not None:
        cig = cigar_from_ops(result.ops[i], int(result.op_count[i]))
        if cig != "*":
            trimmed, shift = trim_edge_deletions(parse_cigar(cig))
            cig = unparse_cigar(trimmed)
    # locate AFTER the edge-deletion shift: a leading-deletion
    # alignment seeded just inside the inter-contig spacer belongs to
    # the contig its first aligned base lands in, not its neighbour
    contig, local = refmap.locate(int(result.position[i]) + shift)
    if seqs is not None:
        seq = _revcomp_str(seqs[i]) if rev else seqs[i]
    else:
        seq = decode_to_str(revcomp(reads[i]) if rev else reads[i])
    qual = quals[i][::-1] if rev else quals[i]
    return contig, local, cig, seq, _qual_str(qual), rev


def emit_alignments(result, names: list[str], reads: np.ndarray,
                    quals: np.ndarray, refmap: ReferenceMap, *,
                    seqs: list[str] | None = None) -> Iterator[str]:
    """MappingResult batch -> SAM record lines (single-end).

    ``reads``/``quals`` are in *as-sequenced* orientation; reverse-strand
    hits (``result.strand == 1``) are flipped here.  ``result.ops`` may
    be None — those records carry CIGAR ``"*"``.

    Pass ``seqs`` (the raw FASTQ sequence text, e.g. ``ReadChunk.seqs``)
    to emit SEQ verbatim — the engine's codes rewrite N to A for k-mer
    seeding, and SAM output must not present those as real A bases.
    """
    for i, name in enumerate(names):
        if not result.mapped[i]:
            seq = seqs[i] if seqs is not None else decode_to_str(reads[i])
            yield sam_record(name, FLAG_UNMAPPED, "*", 0, 0, "*",
                             seq, _qual_str(quals[i]))
            continue
        contig, local, cig, seq, qual, rev = _mapped_fields(
            result, i, reads, quals, seqs, refmap)
        yield sam_record(name, FLAG_REVERSE if rev else 0, contig.name,
                         local + 1, MAPQ_UNAVAILABLE, cig, seq,
                         qual, nm=int(result.distance[i]))


def emit_paired_alignments(pairs, names: list[str],
                           reads1, quals1, reads2, quals2,
                           refmap: ReferenceMap, *,
                           seqs1: list[str] | None = None,
                           seqs2: list[str] | None = None) -> Iterator[str]:
    """PairResolution batch -> interleaved R1/R2 SAM record lines.

    ``pairs`` is a ``repro_torch.core.pairing.PairResolution``; ``names``
    are the shared template QNAMEs (``PairedFastqStream`` chunk names).  Per
    pair the two records carry the full FLAG pairing algebra (0x1
    always; 0x40/0x80 mate identity; 0x2 on proper pairs; 0x8/0x20
    mirroring the mate's state), RNEXT ``=``/contig/``*``, PNEXT, and
    symmetric TLEN (leftmost mate positive; ties broken toward R1), plus
    the calibrated MAPQ from the pair resolution.  Unmapped mates keep
    the validator's unmapped shape (RNAME ``*``, POS 0, CIGAR ``*``) but
    still point RNEXT/PNEXT at a mapped mate's locus.
    """
    res = (pairs.res1, pairs.res2)
    reads = (reads1, reads2)
    quals = (quals1, quals2)
    seqs = (seqs1, seqs2)
    mapqs = (pairs.mapq1, pairs.mapq2)
    mate_flag = (FLAG_READ1, FLAG_READ2)
    for i, name in enumerate(names):
        mapped = [bool(res[m].mapped[i]) for m in (0, 1)]
        fields = [
            _mapped_fields(res[m], i, reads[m], quals[m], seqs[m], refmap)
            if mapped[m] else None
            for m in (0, 1)]
        proper = bool(pairs.proper[i])
        # reference footprint per mate (for TLEN): CIGAR when present,
        # read length otherwise (the mesh path's CIGAR-less records)
        span = [None, None]
        for m in (0, 1):
            if mapped[m]:
                contig, local, cig, _, _, _ = fields[m]
                ref_len = (cigar_ref_len(cig) if cig != "*"
                           else np.asarray(reads[m]).shape[1])
                span[m] = (contig, local, local + ref_len)
        tlen = [0, 0]
        if mapped[0] and mapped[1] and span[0][0] is span[1][0]:
            lo = min(span[0][1], span[1][1])
            hi = max(span[0][2], span[1][2])
            if (span[0][1], 0) <= (span[1][1], 1):  # ties: R1 leftmost
                tlen = [hi - lo, lo - hi]
            else:
                tlen = [lo - hi, hi - lo]
        for m in (0, 1):
            o = 1 - m
            flag = FLAG_PAIRED | mate_flag[m]
            if proper:
                flag |= FLAG_PROPER
            if not mapped[m]:
                flag |= FLAG_UNMAPPED
            if not mapped[o]:
                flag |= FLAG_MATE_UNMAPPED
            if mapped[o] and fields[o][5]:
                flag |= FLAG_MATE_REVERSE
            if not mapped[m]:
                seq = (seqs[m][i] if seqs[m] is not None
                       else decode_to_str(reads[m][i]))
                rnext, pnext = "*", 0
                if mapped[o]:  # point at the mate so the pair stays
                    #            co-locatable in sorted output
                    rnext = fields[o][0].name
                    pnext = fields[o][1] + 1
                yield sam_record(name, flag, "*", 0, 0, "*", seq,
                                 _qual_str(quals[m][i]), rnext=rnext,
                                 pnext=pnext, tlen=0)
                continue
            contig, local, cig, seq, qual, rev = fields[m]
            if rev:
                flag |= FLAG_REVERSE
            rnext, pnext = "*", 0
            if mapped[o]:
                o_contig, o_local = fields[o][0], fields[o][1]
                rnext = "=" if o_contig is contig else o_contig.name
                pnext = o_local + 1
            yield sam_record(name, flag, contig.name, local + 1,
                             int(mapqs[m][i]), cig, seq, qual,
                             rnext=rnext, pnext=pnext, tlen=tlen[m],
                             nm=int(res[m].distance[i]))


def write_sam(handle, header_lines: Iterable[str],
              records: Iterable[str]) -> int:
    """Write header + records; returns the record count."""
    for line in header_lines:
        handle.write(line + "\n")
    n = 0
    for rec in records:
        handle.write(rec + "\n")
        n += 1
    return n


# --------------------------------------------------------------------------
# Dependency-free validator (the tests/CI oracle for this boundary)
# --------------------------------------------------------------------------

def _check(cond: bool, msg: str) -> None:
    """Explicit raise instead of ``assert``: the validator must keep
    validating under ``python -O`` (asserts are stripped there)."""
    if not cond:
        raise AssertionError(msg)


def validate_sam(text: str, *, expect_reads: int | None = None,
                 require_mapq: bool = False) -> dict:
    """Check a SAM document's structural invariants; raise on violation.

    Record checks: @HD first with a VN; at least one @SQ with SN/LN;
    every record has >= 11 tab-separated mandatory columns with
    well-typed FLAG/POS/MAPQ; unmapped records (FLAG 0x4) carry */0/*;
    mapped records name a known @SQ contig, sit inside [1, LN], and any
    non-``*`` CIGAR consumes exactly ``len(SEQ)`` query bases; QUAL
    length matches SEQ; RNEXT is ``*``, ``=`` or a known contig, with
    ``=`` only legal on a mapped record (an RNAME to equal), PNEXT
    inside the mate contig, and ``*`` implying PNEXT/TLEN 0; the
    paired-only FLAG bits (0x2/0x8/0x20/0x40/0x80) appear only with 0x1.

    Pair checks (templates whose records set 0x1): exactly two primary
    records per QNAME, one 0x40 and one 0x80; the 0x2/proper bit equal
    on both mates and only set when both are mapped; each record's 0x8
    mirrors its mate's 0x4 and its 0x20 mirrors its mate's 0x10;
    TLEN(R1) == -TLEN(R2); RNEXT/PNEXT resolve to the mate's RNAME/POS.

    ``require_mapq=True`` additionally demands a *computed* mapping
    quality on every mapped record — MAPQ in [0, 254], rejecting the 255
    "unavailable" placeholder (the paired path always computes one).

    Returns summary counts.
    """
    lines = [ln for ln in text.split("\n") if ln != ""]
    _check(bool(lines) and lines[0].startswith("@HD\t"),
           "missing @HD header")
    _check("VN:" in lines[0], "@HD lacks VN")
    sq = {}
    n_header = 0
    for ln in lines:
        if not ln.startswith("@"):
            break
        n_header += 1
        if ln.startswith("@SQ"):
            tags = dict(t.split(":", 1) for t in ln.split("\t")[1:])
            _check("SN" in tags and "LN" in tags, f"bad @SQ line: {ln!r}")
            sq[tags["SN"]] = int(tags["LN"])
    _check(bool(sq), "no @SQ lines")
    n = n_mapped = n_reverse = n_paired = n_proper = 0
    templates: dict[str, list] = {}
    for ln in lines[n_header:]:
        _check(not ln.startswith("@"), "header line after records")
        f = ln.split("\t")
        _check(len(f) >= 11, f"record has {len(f)} < 11 columns: {ln!r}")
        qname, flag, rname, pos, mapq, cig, rnext, pnext, tlen, seq, \
            qual = f[:11]
        flag, pos, mapq = int(flag), int(pos), int(mapq)
        pnext, tlen = int(pnext), int(tlen)
        _check(bool(qname) and 0 <= mapq <= 255, f"bad QNAME/MAPQ: {ln!r}")
        _check(len(qual) == len(seq), f"QUAL/SEQ length mismatch: {ln!r}")
        mapped = not (flag & FLAG_UNMAPPED)
        if require_mapq and mapped:
            _check(mapq <= 254, f"mapped record with MAPQ {mapq} outside "
                                f"[0, 254] (255 = 'unavailable'): {ln!r}")
        # mate placement fields are checked on every record, paired or not
        _check(rnext == "*" or rnext == "=" or rnext in sq,
               f"RNEXT {rnext!r} is neither *, = nor an @SQ contig: {ln!r}")
        _check(rnext != "=" or rname != "*",
               f"RNEXT '=' but RNAME is '*' (no contig to equal): {ln!r}")
        if rnext == "*":
            _check(pnext == 0 and tlen == 0,
                   f"RNEXT '*' with PNEXT/TLEN set: {ln!r}")
        else:
            mate_contig = rname if rnext == "=" else rnext
            _check(0 <= pnext <= sq[mate_contig],
                   f"PNEXT {pnext} outside [0, {sq[mate_contig]}]: {ln!r}")
        if not (flag & FLAG_PAIRED):
            _check(not (flag & _PAIRED_ONLY_FLAGS),
                   f"paired-only FLAG bits without 0x1: {ln!r}")
        else:
            n_paired += 1
            templates.setdefault(qname, []).append(
                (flag, rname, pos, rnext, pnext, tlen, ln))
        n += 1
        if not mapped:
            _check(rname == "*" and pos == 0 and cig == "*",
                   f"unmapped record with placement fields: {ln!r}")
            continue
        n_mapped += 1
        n_reverse += bool(flag & FLAG_REVERSE)
        _check(rname in sq, f"RNAME {rname!r} not in @SQ")
        _check(1 <= pos <= sq[rname], f"POS {pos} outside [1, {sq[rname]}]")
        if cig != "*":
            _check(cigar_query_len(cig) == len(seq),
                   f"CIGAR consumes {cigar_query_len(cig)} query bases "
                   f"but SEQ has {len(seq)}: {ln!r}")
            parsed = parse_cigar(cig)
            _check(parsed[0][1] != "D" and parsed[-1][1] != "D",
                   f"CIGAR begins/ends with a deletion: {ln!r}")
            end = pos + cigar_ref_len(cig) - 1
            _check(end <= sq[rname],
                   f"alignment footprint [{pos}, {end}] extends past "
                   f"{rname}'s LN {sq[rname]}: {ln!r}")
    for qname, recs in templates.items():
        n_proper += _check_pair(qname, recs)
    if expect_reads is not None:
        _check(n == expect_reads, f"{n} records != {expect_reads} reads")
    return dict(n_records=n, n_mapped=n_mapped, n_reverse=n_reverse,
                n_paired=n_paired, n_proper=n_proper, contigs=sq)


def _check_pair(qname: str, recs: list) -> int:
    """Cross-record consistency of one paired template; returns 1 when
    the pair is proper (0x2) so the caller can count them."""
    _check(len(recs) == 2,
           f"template {qname!r} has {len(recs)} paired records, not 2")
    a, b = recs
    for (flag, _, _, _, _, _, ln) in recs:
        _check(bool(flag & FLAG_READ1) != bool(flag & FLAG_READ2),
               f"paired record needs exactly one of 0x40/0x80: {ln!r}")
    _check(bool(a[0] & FLAG_READ1) != bool(b[0] & FLAG_READ1),
           f"template {qname!r}: both records claim the same mate slot")
    for (flag, rname, _, rnext, pnext, _, ln), \
            (oflag, orname, opos, _, _, _, _) in ((a, b), (b, a)):
        mate_unmapped = bool(oflag & FLAG_UNMAPPED)
        _check(bool(flag & FLAG_MATE_UNMAPPED) == mate_unmapped,
               f"0x8 does not mirror the mate's 0x4: {ln!r}")
        _check(bool(flag & FLAG_MATE_REVERSE)
               == (not mate_unmapped and bool(oflag & FLAG_REVERSE)),
               f"0x20 does not mirror the mate's 0x10: {ln!r}")
        _check(bool(flag & FLAG_PROPER) == bool(oflag & FLAG_PROPER),
               f"0x2 differs between mates: {ln!r}")
        if flag & FLAG_PROPER:
            _check(not (flag & FLAG_UNMAPPED) and not mate_unmapped,
                   f"proper pair (0x2) with an unmapped mate: {ln!r}")
        if not mate_unmapped:
            resolved = rname if rnext == "=" else rnext
            _check(resolved == orname and pnext == opos,
                   f"RNEXT/PNEXT ({resolved!r}, {pnext}) do not point at "
                   f"the mate's RNAME/POS ({orname!r}, {opos}): {ln!r}")
    _check(a[5] == -b[5],
           f"TLEN not symmetric for {qname!r}: {a[5]} vs {b[5]}")
    return int(bool(a[0] & FLAG_PROPER))
