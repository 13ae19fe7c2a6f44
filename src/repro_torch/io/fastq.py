"""Streaming FASTQ ingestion in engine-shaped batches — ``repro.io.fastq``
without its fault-injection hook.

The mapping engine wants fixed ``(chunk, read_len)`` uint8 blocks; a
FASTQ file is a variable-length record stream.  ``FastqStream`` bridges
them without ever materializing the file: records are parsed 4 lines at
a time and accumulated into ``chunk_reads``-sized ``ReadChunk`` batches.

Length policy (the pipeline is fixed-``read_len``, like DART-PIM's
crossbar rows): the first record sets ``read_len`` unless the caller
pins it; longer reads are truncated to it, shorter reads are skipped.
Both are counted (``n_truncated`` / ``n_skipped``) so silent data loss
is impossible.  Read bases outside ACGT encode to A (the 2-bit k-mer
alphabet has no N slot — same policy as ``core.encoding.encode_str``);
qualities ride along as raw phred+33 bytes for SAM emission.

Malformed-record policy (``on_error``): real-world FASTQ carries bad
records — quality strings of the wrong length, missing ``+`` separators,
truncated final records, corrupt gzip members.  ``on_error="strict"``
(default) raises ``FastqParseError`` with ``file:line`` context at the
first bad record.  ``on_error="permissive"`` *quarantines* instead: the
raw record is written to the ``rejects`` FASTQ (when given), counted in
``n_rejected`` / ``reject_reasons``, its name recorded in
``rejected_names``, and parsing resynchronizes at the next ``@`` header
— corruption costs the records it touched, never the run.

``.fastq.gz`` paths stream through gzip transparently (``fasta._open``)
and parse bit-identically to the plain file; a truncated gzip stream
raises a ``ValueError`` naming the failure (strict) or ends the stream
as a counted rejection (permissive).

``PairedFastqStream`` is the paired-end entry: two R1/R2 files (or one
interleaved file) iterated in lockstep as ``(chunk1, chunk2)`` pairs,
with mate names cross-checked (``/1``/``/2`` suffixes stripped) and the
length policy applied *per pair* — if either mate is too short the whole
pair is skipped, so the two chunks stay index-aligned mate-for-mate.
Under ``permissive`` a mid-stream mate-name desync re-pairs via a
one-record lookahead (the orphaned mate is quarantined) and an unpaired
tail becomes a counted rejection instead of an exception.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterator

import numpy as np

from ..core.encoding import encode_str

DEFAULT_CHUNK_READS = 1024

ON_ERROR = ("strict", "permissive")

# trailing mate designator: read7/1, read7/2.  ONLY the '/1'-'/2'
# convention is stripped — '.1'/'_1' are real name parts in the wild
# (SRA spot names are 'SRR123.1', 'SRR123.2', ... for *different*
# templates; stripping those would conflate them into one QNAME)
_MATE_SUFFIX_RE = re.compile(r"/[12]$")


def mate_base_name(name: str) -> str:
    """QNAME with a trailing ``/1``/``/2`` mate designator stripped —
    the canonical template name both mates must share (and the QNAME the
    SAM spec wants: identical for both records of a pair)."""
    return _MATE_SUFFIX_RE.sub("", name)



class FastqParseError(ValueError):
    """A malformed FASTQ record, located: ``source:lineno: reason``.

    ``reason`` is the bare diagnosis, ``slug`` its stable key in
    ``reject_reasons``, ``lines`` the raw text consumed for the record
    (what a permissive stream writes to the rejects file), ``name`` the
    record's QNAME when the header was parseable.
    """

    def __init__(self, reason: str, source: str, lineno: int,
                 lines=(), name: str | None = None,
                 slug: str = "malformed"):
        super().__init__(f"{source}:{lineno}: {reason}")
        self.reason = reason
        self.slug = slug
        self.source = source
        self.lineno = lineno
        self.lines = list(lines)
        self.name = name


class _RejectSink:
    """Lazily-opened rejects FASTQ shared by the streams of a paired
    source (one file, one writer — the two mates must not truncate each
    other's rejects)."""

    def __init__(self, spec):
        self.spec = spec
        self._f = None
        self._owned = False

    def write(self, lines) -> None:
        if self.spec is None or not lines:
            return
        if self._f is None:
            from .fasta import _open
            self._f, self._owned = _open(self.spec, "w")
        self._f.write("".join(lines))

    def close(self) -> None:
        if self._f is not None and self._owned:
            self._f.close()
        self._f = None


@dataclasses.dataclass
class ReadChunk:
    """One engine-shaped batch of FASTQ records."""
    names: list[str]         # per-read QNAMEs (header token before space)
    reads: np.ndarray        # (n, read_len) uint8 base codes
    quals: np.ndarray        # (n, read_len) uint8 phred+33 ASCII
    seqs: list[str] | None = None  # raw sequence text (read_len chars):
    #                        codes rewrite N->A for seeding, SAM SEQ must
    #                        not — pass this to sam.emit_alignments

    def __len__(self) -> int:
        return len(self.names)


def _encode_read(seq: str, read_len: int) -> np.ndarray:
    # one home for the base-encoding policy (unknown -> A): core.encoding
    return encode_str(seq)[:read_len]


class FastqStream:
    """Iterate a FASTQ file as ``ReadChunk`` batches.

    Parameters
    ----------
    path : str | file-like
        FASTQ source (4-line records).
    read_len : int, optional
        Fixed read length; inferred from the first record when None
        (the first record is read eagerly at construction so callers can
        size the index before iterating).
    chunk_reads : int
        Batch size; the last chunk may be shorter.  Match this to
        ``MapperConfig.chunk_reads`` so each chunk feeds the streaming
        engine as one unit.
    on_error : "strict" | "permissive"
        Malformed-record policy (module docstring).  Strict raises
        ``FastqParseError`` with file:line context; permissive counts,
        quarantines and resynchronizes.
    rejects : str | file-like | _RejectSink, optional
        Where permissive mode writes quarantined raw records (a FASTQ-
        shaped rejects file; ``.gz`` spelled paths compress).  Opened
        lazily on the first rejection.
    injector : FaultInjector, optional
        Chaos hook: a fired ``"fastq_record"`` site marks the cleanly
        parsed record corrupt (rejected or raised per ``on_error``) —
        deterministic corruption for the chaos tests.
    """

    def __init__(self, path_or_handle, read_len: int | None = None,
                 chunk_reads: int = DEFAULT_CHUNK_READS, *,
                 on_error: str = "strict", rejects=None, injector=None):
        if chunk_reads < 1:
            raise ValueError(f"chunk_reads={chunk_reads!r} must be >= 1")
        if on_error not in ON_ERROR:
            raise ValueError(f"on_error={on_error!r}; expected one of "
                             f"{ON_ERROR}")
        from .fasta import _open
        self._f, self._owned = _open(path_or_handle)
        self.source = (path_or_handle if isinstance(path_or_handle, str)
                       else getattr(self._f, "name", "<stream>"))
        self.chunk_reads = chunk_reads
        self.on_error = on_error
        self.injector = injector
        self._sink = (rejects if isinstance(rejects, _RejectSink)
                      else _RejectSink(rejects))
        self.n_reads = 0       # records emitted (post length policy)
        self.n_skipped = 0     # records shorter than read_len
        self.n_truncated = 0   # records longer than read_len
        self.n_rejected = 0    # malformed records quarantined (permissive)
        self.reject_reasons: dict[str, int] = {}
        self.rejected_names: list[str] = []
        self._lineno = 0
        self._line_at = 0       # lineno of the line _readline last gave
        self._pushback: tuple[str, int] | None = None
        self._rec_lines: list[str] = []
        self._peeked = None     # (record, raw lines) | None
        try:
            first = self._next_record()
            if first is None:
                raise ValueError(f"{self.source}: empty FASTQ: no records")
            self.read_len = (read_len if read_len is not None
                             else len(first[1]))
            if self.read_len < 1:
                raise ValueError(f"read_len={self.read_len!r} must be >= 1")
        except Exception:
            if self._owned:  # don't leak the fd when the peek fails
                self._f.close()
            raise
        self._peeked = (first, list(self._rec_lines))

    # ------------------------------------------------------ line plumbing

    def _readline(self) -> str:
        if self._pushback is not None:
            line, self._line_at = self._pushback
            self._pushback = None
        else:
            line = self._f.readline()
            self._lineno += 1
            self._line_at = self._lineno
        self._rec_lines.append(line)
        return line

    def _push_back(self, line: str, lineno: int) -> None:
        self._pushback = (line, lineno)
        if self._rec_lines and self._rec_lines[-1] is line:
            self._rec_lines.pop()

    def push_back_record(self, rec, lines) -> None:
        """Un-consume a record (the paired stream's desync lookahead)."""
        if self._peeked is not None:
            raise RuntimeError("only one record of pushback is supported")
        self._peeked = (rec, list(lines))

    # ----------------------------------------------------------- parsing

    def _next_record(self):
        """Next raw ``(name, seq, qual)`` or None at EOF.

        Strict mode raises ``FastqParseError`` (or ``ValueError`` for a
        truncated gzip stream) at the first malformed record; permissive
        mode quarantines it (``_reject``), resynchronizes at the next
        ``@`` header, and keeps going.  ``self._rec_lines`` holds the raw
        text of the returned record.
        """
        if self._peeked is not None:
            (rec, lines), self._peeked = self._peeked, None
            self._rec_lines = lines
            return rec
        while True:
            try:
                rec = self._parse_record()
            except EOFError as e:  # gzip: stream ends before EOF marker
                if self.on_error == "permissive":
                    self._reject("truncated_gzip", None, [])
                    return None
                raise ValueError(
                    f"{self.source}: truncated gzip FASTQ stream "
                    f"(compressed file ended mid-record): {e}") from e
            except FastqParseError as e:
                if self.on_error == "strict":
                    raise
                self._reject(e.slug, e.name, e.lines)
                self._resync()
                continue
            if (rec is not None and self.injector is not None
                    and self.injector.fire("fastq_record")):
                err = FastqParseError("injected record corruption",
                                      self.source, self._line_at,
                                      self._rec_lines, rec[0],
                                      slug="injected")
                if self.on_error == "strict":
                    raise err
                self._reject(err.slug, err.name, err.lines)
                continue  # a clean record was consumed: no resync needed
            return rec

    def _parse_record(self):
        self._rec_lines = []
        head = self._readline()
        while head is not None and head.strip() == "" and head != "":
            self._rec_lines = []
            head = self._readline()
        if not head:
            return None
        start = self._line_at
        head = head.strip()
        if not head.startswith("@"):
            raise FastqParseError(f"malformed FASTQ: expected '@' header, "
                                  f"got {head[:40]!r}", self.source, start,
                                  self._rec_lines, slug="bad_header")
        name = head[1:].split()[0] if len(head) > 1 else "*"
        seq = self._readline().strip()
        plus = self._readline().strip()
        qual = self._readline().strip()
        if not plus.startswith("+"):
            raise FastqParseError(f"malformed FASTQ record {head[:40]!r}: "
                                  f"missing '+' separator line",
                                  self.source, start, self._rec_lines, name,
                                  slug="missing_separator")
        if len(qual) != len(seq):
            raise FastqParseError(f"malformed FASTQ record {head[:40]!r}: "
                                  f"{len(seq)} bases but {len(qual)} "
                                  f"qualities", self.source, start,
                                  self._rec_lines, name,
                                  slug="qual_len_mismatch")
        return name, seq, qual

    def _reject(self, slug: str, name: str | None, lines) -> None:
        self.n_rejected += 1
        self.reject_reasons[slug] = self.reject_reasons.get(slug, 0) + 1
        if name is not None:
            self.rejected_names.append(name)
        self._sink.write(lines)

    def _resync(self) -> None:
        """Skip forward to the next plausible record header so one bad
        record costs itself, not the rest of the file."""
        while True:
            line = self._f.readline()
            if not line:
                return
            self._lineno += 1
            if line.startswith("@"):
                self._pushback = (line, self._lineno)
                return

    def __iter__(self) -> Iterator[ReadChunk]:
        rl = self.read_len
        chunk = _ChunkBuilder(rl)
        try:
            while True:
                rec = self._next_record()
                if rec is None:
                    break
                name, seq, qual = rec
                if len(seq) < rl:
                    self.n_skipped += 1
                    continue
                if len(seq) > rl:
                    self.n_truncated += 1
                chunk.add(name, seq, qual)
                if len(chunk) == self.chunk_reads:
                    self.n_reads += len(chunk)
                    yield chunk.emit()
            if len(chunk):
                self.n_reads += len(chunk)
                yield chunk.emit()
        finally:
            # close the owned handles even on early break / parse error
            # (generator finalization triggers this via GeneratorExit)
            if self._owned:
                self._f.close()
            self._sink.close()


def parse_fastq(path_or_handle, read_len: int | None = None,
                chunk_reads: int = DEFAULT_CHUNK_READS,
                ) -> Iterator[ReadChunk]:
    """Functional spelling of ``FastqStream`` (counts live on the
    stream object; use the class when you need them)."""
    return iter(FastqStream(path_or_handle, read_len=read_len,
                            chunk_reads=chunk_reads))


class _ChunkBuilder:
    """Accumulates records into one ReadChunk: the one home of the
    per-record encoding policy (shared by the two mates of
    ``PairedFastqStream`` so their policy cannot drift)."""

    def __init__(self, read_len: int):
        self.rl = read_len
        self.names, self.reads, self.quals, self.seqs = [], [], [], []

    def add(self, name: str, seq: str, qual: str) -> None:
        rl = self.rl
        self.names.append(name)
        self.reads.append(_encode_read(seq, rl))
        self.quals.append(np.frombuffer(qual[:rl].encode("ascii"),
                                        dtype=np.uint8))
        self.seqs.append(seq[:rl])

    def __len__(self) -> int:
        return len(self.names)

    def emit(self) -> ReadChunk:
        chunk = ReadChunk(self.names, np.stack(self.reads),
                          np.stack(self.quals), self.seqs)
        self.names, self.reads, self.quals, self.seqs = [], [], [], []
        return chunk


class PairedFastqStream:
    """Iterate paired-end FASTQ as lockstep ``(chunk1, chunk2)`` batches.

    Two source layouts:

    * two files — ``PairedFastqStream(r1_path, r2_path)``: record *i* of
      R1 pairs with record *i* of R2;
    * interleaved — ``PairedFastqStream(path, interleaved=True)``:
      records ``2i``/``2i+1`` are the R1/R2 mates of pair *i*.

    Both mates must share a template name once the ``/1``/``/2``-style
    suffix is stripped (``mate_base_name``); a mismatch or a mate count
    imbalance raises instead of silently re-pairing.  The fixed-length
    policy is applied per *pair*: if either mate is shorter than
    ``read_len`` the whole pair is skipped (``n_skipped`` counts pairs),
    so ``chunk1[i]`` and ``chunk2[i]`` are always mates.  ``names`` on
    the emitted chunks carry the shared template name — exactly the SAM
    QNAME both records of the pair must use.

    ``on_error="permissive"`` extends the per-record quarantine policy
    (see ``FastqStream``) with pair-level recovery: on a mate-name
    desync, a one-record lookahead on each side re-pairs the streams and
    quarantines the orphaned mate (reason ``mate_desync``); when it
    cannot re-pair, both records are quarantined and lockstep continues.
    An unpaired tail quarantines the surviving record (reason
    ``unpaired_tail``) and ends the stream.  Both substreams share one
    ``rejects`` sink.

    ``.gz`` paths stream through gzip transparently on either layout.
    """

    def __init__(self, r1, r2=None, *, interleaved: bool = False,
                 read_len: int | None = None,
                 chunk_reads: int = DEFAULT_CHUNK_READS,
                 on_error: str = "strict", rejects=None, injector=None):
        if interleaved and r2 is not None:
            raise ValueError("interleaved=True takes a single source; "
                             "r2 must be None")
        if not interleaved and r2 is None:
            raise ValueError("paired input needs r2 (or interleaved=True)")
        if chunk_reads < 1:
            raise ValueError(f"chunk_reads={chunk_reads!r} must be >= 1")
        if on_error not in ON_ERROR:
            raise ValueError(f"on_error={on_error!r}; expected one of "
                             f"{ON_ERROR}")
        self.interleaved = interleaved
        self.chunk_reads = chunk_reads
        self.on_error = on_error
        self._sink = _RejectSink(rejects)
        self._s1 = FastqStream(r1, read_len=read_len, chunk_reads=chunk_reads,
                               on_error=on_error, rejects=self._sink,
                               injector=injector)
        self.read_len = self._s1.read_len
        self._s2 = (self._s1 if interleaved else
                    FastqStream(r2, read_len=self.read_len,
                                chunk_reads=chunk_reads, on_error=on_error,
                                rejects=self._sink, injector=injector))
        self.n_pairs = 0      # pairs emitted (post length policy)
        self.n_skipped = 0    # pairs dropped because a mate was short
        self.n_truncated = 0  # mates longer than read_len (counted singly)
        self.n_rejected_pairs = 0  # pair-level quarantines (permissive)
        self.reject_reasons: dict[str, int] = {}

    @property
    def n_rejected(self) -> int:
        """All quarantined records: per-record parse rejections on either
        substream plus the pair-level desync/tail quarantines."""
        n = self._s1.n_rejected + self.n_rejected_pairs
        if not self.interleaved:
            n += self._s2.n_rejected
        return n

    @property
    def rejected_names(self) -> list[str]:
        names = list(self._s1.rejected_names)
        if not self.interleaved:
            names += self._s2.rejected_names
        return names

    def _reject_pair(self, reason: str, *recs) -> None:
        """Quarantine record(s) at the pair level: ``recs`` are
        ``(stream, record, raw_lines)`` triples."""
        self.n_rejected_pairs += 1
        self.reject_reasons[reason] = \
            self.reject_reasons.get(reason, 0) + 1
        for stream, rec, lines in recs:
            if rec is not None:
                stream.rejected_names.append(rec[0])
                self._sink.write(lines)

    def _next_pair(self):
        while True:
            r1 = self._s1._next_record()
            l1 = list(self._s1._rec_lines)
            r2 = self._s2._next_record()
            l2 = list(self._s2._rec_lines)
            if r1 is None and r2 is None:
                return None
            if (r1 is None) != (r2 is None):
                which = "R1" if r1 is None else "R2"
                if self.on_error == "permissive":
                    # quarantine the survivor; the stream is over
                    alive = ((self._s2, r2, l2) if r1 is None
                             else (self._s1, r1, l1))
                    self._reject_pair("unpaired_tail", alive)
                    return None
                raise ValueError(f"unpaired FASTQ input: {which} ended "
                                 f"before its mate stream")
            b1, b2 = mate_base_name(r1[0]), mate_base_name(r2[0])
            if b1 == b2:
                return b1, r1, r2
            if self.on_error == "strict":
                raise ValueError(f"mate name mismatch: {r1[0]!r} vs "
                                 f"{r2[0]!r} (template {b1!r} != {b2!r})")
            # permissive desync recovery: one-record lookahead per side —
            # if the *next* R1 pairs with this R2, the current R1 is an
            # orphan (and vice versa); otherwise drop both and move on
            n1 = self._s1._next_record()
            ln1 = list(self._s1._rec_lines)
            if n1 is not None and mate_base_name(n1[0]) == b2:
                self._reject_pair("mate_desync", (self._s1, r1, l1))
                return b2, n1, r2
            if n1 is not None:
                self._s1.push_back_record(n1, ln1)
            n2 = self._s2._next_record()
            ln2 = list(self._s2._rec_lines)
            if n2 is not None and mate_base_name(n2[0]) == b1:
                self._reject_pair("mate_desync", (self._s2, r2, l2))
                return b1, r1, n2
            if n2 is not None:
                self._s2.push_back_record(n2, ln2)
            self._reject_pair("mate_desync", (self._s1, r1, l1),
                              (self._s2, r2, l2))

    def __iter__(self) -> Iterator[tuple[ReadChunk, ReadChunk]]:
        rl = self.read_len
        c1, c2 = _ChunkBuilder(rl), _ChunkBuilder(rl)
        try:
            while True:
                pair = self._next_pair()
                if pair is None:
                    break
                base, (_, s1, q1), (_, s2, q2) = pair
                if len(s1) < rl or len(s2) < rl:
                    self.n_skipped += 1  # pair integrity: drop both mates
                    continue
                self.n_truncated += (len(s1) > rl) + (len(s2) > rl)
                c1.add(base, s1, q1)
                c2.add(base, s2, q2)
                if len(c1) == self.chunk_reads:
                    self.n_pairs += len(c1)
                    yield c1.emit(), c2.emit()
            if len(c1):
                self.n_pairs += len(c1)
                yield c1.emit(), c2.emit()
        finally:
            if self._s1._owned:
                self._s1._f.close()
            if not self.interleaved and self._s2._owned:
                self._s2._f.close()
            self._sink.close()
