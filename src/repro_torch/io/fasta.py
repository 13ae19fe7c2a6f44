"""Streaming multi-record FASTA parsing (reference ingestion) — a copy of
``repro.io.fasta``.

Real references are multi-contig and carry ambiguity codes; the mapping
core works on one flat ``uint8`` array.  The bridge is deliberate:

* every non-ACGT base (N and the rarer IUPAC codes) maps to the index's
  ``SENTINEL`` (4), which never equals a read base — a candidate window
  overlapping an N run pays one edit per N, so mapping *near* ambiguity
  is allowed and mapping *onto* it is rejected by the linear-WF filter,
  with no special casing downstream;
* contigs are concatenated with a run of ``spacer`` sentinel bases
  between them, so no read can align across a contig boundary (the
  spacer is sized >= one full alignment window);
* the ``Contig`` table remembers each contig's name/length/offset, and
  ``ReferenceMap`` converts the mapper's global positions back to
  SAM-style (contig, 1-based local) coordinates.

Parsing streams the file line by line (no whole-file string), so a
reference is held once as codes, never twice as text.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, TextIO

import numpy as np

from ..core.encoding import SENTINEL

# non-ACGT -> SENTINEL (never matches a read base)
_REF_LUT = np.full(256, SENTINEL, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _REF_LUT[ord(_c)] = _i
    _REF_LUT[ord(_c.lower())] = _i


def _open(path_or_handle, mode="r"):
    """Open a path (gzip-transparent) or pass a handle through.

    Returns ``(handle, owned)``.  Paths ending in ``.gz`` open through
    ``gzip`` in text mode, so every reader and writer built on this —
    FASTA/FASTQ parsing, the simulator's ``write_fasta``/``write_fastq``
    — handles ``.fastq.gz`` files with zero caller changes.  Compression
    is detected by extension, not magic bytes: a misnamed file fails fast
    in the parser instead of silently streaming gzip framing as bases.
    """
    if hasattr(path_or_handle, "read") or hasattr(path_or_handle, "write"):
        return path_or_handle, False
    if str(path_or_handle).endswith(".gz"):
        import gzip
        return gzip.open(path_or_handle, mode + "t"), True
    return open(path_or_handle, mode), True


def encode_ref_line(line: str) -> np.ndarray:
    """ASCII reference bases -> uint8 codes, non-ACGT -> SENTINEL."""
    return _REF_LUT[np.frombuffer(line.encode("ascii"), dtype=np.uint8)]


@dataclasses.dataclass(frozen=True)
class Contig:
    """One reference sequence and where it landed in the flat array."""
    name: str
    length: int
    offset: int       # start in the concatenated reference


def parse_fasta(path_or_handle) -> Iterator[tuple[str, np.ndarray]]:
    """Yield ``(name, codes)`` per record, streaming line by line.

    ``name`` is the first whitespace-delimited token of the header (the
    SAM ``SN`` convention); ``codes`` is uint8 with non-ACGT -> SENTINEL.
    A record's lines are encoded in one call.
    """
    f, owned = _open(path_or_handle)
    try:
        name, parts = None, []
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, encode_ref_line("".join(parts))
                name, parts = line[1:].split()[0] if len(line) > 1 else "", []
                if not name:
                    raise ValueError("FASTA record with empty header name")
            else:
                if name is None:
                    raise ValueError("FASTA sequence data before any "
                                     "'>' header line")
                parts.append(line)
        if name is not None:
            yield name, encode_ref_line("".join(parts))
    finally:
        if owned:
            f.close()


def stream_fasta(path_or_handle, *,
                 max_chunk: int = 1 << 20,
                 ) -> Iterator[tuple[str, np.ndarray, bool]]:
    """Yield ``(name, codes_chunk, is_last)`` streaming each contig in
    bounded pieces, never holding a whole contig.

    Unlike :func:`parse_fasta` (which concatenates a record before
    yielding it), this caps resident sequence at ~``max_chunk`` bases —
    the ingestion contract an out-of-core index builder needs so a
    chromosome-sized contig costs tile-sized memory.  ``is_last`` marks the final chunk of a record;
    a record with no sequence lines yields one empty last chunk so
    callers can reject it by name.  A chunk's lines are encoded in one
    call, not a call a line.
    """
    f, owned = _open(path_or_handle)
    try:
        name, parts, buffered = None, [], 0

        def flush(last: bool):
            nonlocal parts, buffered
            chunk = encode_ref_line("".join(parts))
            parts, buffered = [], 0
            return name, chunk, last

        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield flush(True)
                name = line[1:].split()[0] if len(line) > 1 else ""
                if not name:
                    raise ValueError("FASTA record with empty header name")
            else:
                if name is None:
                    raise ValueError("FASTA sequence data before any "
                                     "'>' header line")
                parts.append(line)
                buffered += len(line)
                if buffered >= max_chunk:
                    yield flush(False)
        if name is not None:
            yield flush(True)
    finally:
        if owned:
            f.close()


class ReferenceMap:
    """Global (concatenated) position <-> per-contig coordinates."""

    def __init__(self, contigs: list[Contig]):
        if not contigs:
            raise ValueError("empty reference: no contigs")
        self.contigs = contigs
        self._starts = np.array([c.offset for c in contigs], dtype=np.int64)

    def locate(self, pos: int) -> tuple[Contig, int]:
        """Global position -> ``(contig, 0-based local position)``.

        The mapper's band allows an alignment start a few bases off the
        seeded position, so a global position inside a spacer is
        attributed to the *nearest* contig edge — a start just before
        contig ``i+1`` belongs to ``i+1``'s first base, not ``i``'s last
        — and clamped into it.
        """
        i = int(np.searchsorted(self._starts, pos, side="right")) - 1
        i = max(i, 0)
        c = self.contigs[i]
        if pos >= c.offset + c.length and i + 1 < len(self.contigs):
            nxt = self.contigs[i + 1]
            if nxt.offset - pos <= pos - (c.offset + c.length - 1):
                c = nxt
        return c, int(np.clip(pos - c.offset, 0, max(c.length - 1, 0)))


def load_reference(path_or_handle, *, spacer: int, on_error: str = "strict",
                   rejected: list | None = None,
                   ) -> tuple[np.ndarray, list[Contig]]:
    """Multi-record FASTA -> (flat uint8 reference, contig table).

    Contigs are joined by ``spacer`` SENTINEL bases (size it >= one
    alignment window, ``read_len + 2*eth``, so no read maps across a
    boundary).  Degenerate records — empty sequence, or *only* non-ACGT
    bases (an all-SENTINEL contig is indistinguishable from its spacer
    and can never be mapped onto) — are rejected: ``on_error="strict"``
    raises naming the contig; ``on_error="permissive"`` skips the contig
    and appends ``(name, reason)`` to ``rejected`` (when given), so a
    draft assembly full of N-only scaffolds still loads.
    """
    if on_error not in ("strict", "permissive"):
        raise ValueError(f"on_error={on_error!r}; expected 'strict' or "
                         f"'permissive'")
    parts, contigs, off = [], [], 0
    for name, codes in parse_fasta(path_or_handle):
        reason = ("no sequence" if len(codes) == 0 else
                  "only non-ACGT (sentinel) bases"
                  if (codes == SENTINEL).all() else None)
        if reason is not None:
            if on_error == "strict":
                raise ValueError(f"FASTA contig {name!r} has {reason}")
            if rejected is not None:
                rejected.append((name, reason))
            continue
        if contigs:
            parts.append(np.full(spacer, SENTINEL, dtype=np.uint8))
            off += spacer
        contigs.append(Contig(name=name, length=len(codes), offset=off))
        parts.append(codes)
        off += len(codes)
    if not contigs:
        raise ValueError("empty FASTA: no records (or none usable)")
    return np.concatenate(parts), contigs
