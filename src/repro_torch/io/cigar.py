"""END-aligned traceback ops -> CIGAR strings (and back).

The affine-WF traceback (``repro_torch.core.affine_wf.traceback``) emits op
codes right-aligned in a fixed ``(R, max_ops)`` buffer, left-padded with
``OP_NONE`` — the device-friendly layout.  SAM wants run-length encoded
CIGAR text.  We emit the exact alignment alphabet (``=`` match, ``X``
substitution, ``I`` insertion-to-reference, ``D`` deletion) rather than
collapsing to ``M``: it is spec-valid and loss-free w.r.t. the
traceback, so the alignment (not just its span) is reconstructible.

Truncation: with a caller-set ``max_ops`` smaller than the walk length,
``op_count`` exceeds the buffer and the stored ops are incomplete —
those alignments degrade to CIGAR ``"*"`` (spec: "CIGAR unavailable")
instead of emitting a string that cannot re-sum to the read length.
"""
from __future__ import annotations

import re

import numpy as np

from ..core.encoding import OP_DEL, OP_INS, OP_MATCH, OP_NONE, OP_SUB

_OP_CHAR = {OP_MATCH: "=", OP_SUB: "X", OP_INS: "I", OP_DEL: "D"}
_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")

# which CIGAR ops consume query (read) vs reference bases (SAM spec 1.6)
QUERY_OPS = set("MIS=X")
REF_OPS = set("MDN=X")


def cigar_from_ops(ops: np.ndarray, op_count: int) -> str:
    """One END-aligned op row + its count -> CIGAR string.

    ``op_count == 0`` (unmapped) and ``op_count > len(ops)`` (the
    ``max_ops`` truncation path — the buffer holds only the tail of the
    walk) both return ``"*"``.
    """
    ops = np.asarray(ops)
    k = int(op_count)
    if k <= 0 or k > ops.shape[-1]:
        return "*"
    tail = ops[ops.shape[-1] - k:]
    if np.any(tail == OP_NONE):  # padding inside the walk: corrupt row
        return "*"
    # run-length encode
    flips = np.flatnonzero(np.diff(tail)) + 1
    bounds = np.concatenate([[0], flips, [k]])
    return "".join(f"{bounds[i + 1] - bounds[i]}{_OP_CHAR[int(tail[bounds[i]])]}"
                   for i in range(len(bounds) - 1))


def cigars_from_result(ops: np.ndarray, op_count: np.ndarray) -> list[str]:
    """Batched ``cigar_from_ops`` over ``(R, max_ops)`` / ``(R,)``."""
    return [cigar_from_ops(ops[r], int(op_count[r]))
            for r in range(len(op_count))]


def parse_cigar(cigar: str) -> list[tuple[int, str]]:
    """CIGAR -> [(length, op)], validating the whole string matches."""
    if cigar == "*":
        return []
    parts = _CIGAR_RE.findall(cigar)
    if "".join(f"{n}{c}" for n, c in parts) != cigar or not parts:
        raise ValueError(f"malformed CIGAR {cigar!r}")
    out = [(int(n), c) for n, c in parts]
    if any(n < 1 for n, _ in out):
        raise ValueError(f"zero-length CIGAR op in {cigar!r}")
    return out


def unparse_cigar(parsed: list[tuple[int, str]]) -> str:
    return "".join(f"{n}{c}" for n, c in parsed) if parsed else "*"


def trim_edge_deletions(parsed: list[tuple[int, str]],
                        ) -> tuple[list[tuple[int, str]], int]:
    """SAM-normalize an op list: an alignment may not begin or end with a
    deletion (no read base is involved in those ref positions — real
    aligners shrink the footprint instead).  The banded-WF traceback can
    emit them when the band's best path enters via the gap matrices;
    drop them and return ``(ops, pos_shift)`` where ``pos_shift`` is the
    number of leading deleted reference bases POS must advance by.
    """
    lo, hi = 0, len(parsed)
    shift = 0
    while lo < hi and parsed[lo][1] == "D":
        shift += parsed[lo][0]
        lo += 1
    while hi > lo and parsed[hi - 1][1] == "D":
        hi -= 1
    return parsed[lo:hi], shift


def cigar_query_len(cigar: str) -> int:
    """Read bases the CIGAR consumes (must equal the SEQ length)."""
    return sum(n for n, c in parse_cigar(cigar) if c in QUERY_OPS)


def cigar_ref_len(cigar: str) -> int:
    """Reference bases the CIGAR consumes (the alignment footprint)."""
    return sum(n for n, c in parse_cigar(cigar) if c in REF_OPS)
