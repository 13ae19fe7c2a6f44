"""Genomics I/O boundary — FASTA references and FASTQ reads in, SAM out
(the single-end part of ``repro.io``):

  ``fasta``  — streaming multi-record FASTA parsing (N -> sentinel) and
               the concatenated-reference + contig-table view the index
               builder consumes.
  ``fastq``  — streaming FASTQ parsing into ``chunk_reads``-sized batches.
  ``cigar``  — END-aligned traceback ops -> CIGAR strings (and back).
  ``sam``    — spec-valid SAM emission plus the dependency-free validator.

The end-to-end driver is ``repro_torch.launch.map_fastq``.
"""
from .cigar import (cigar_from_ops, cigar_query_len, cigar_ref_len,
                    parse_cigar)  # noqa: F401
from .fasta import (Contig, ReferenceMap, load_reference,
                    parse_fasta)  # noqa: F401
from .fastq import FastqStream, ReadChunk, parse_fastq  # noqa: F401
from .sam import (FLAG_REVERSE, FLAG_UNMAPPED, emit_alignments, sam_header,
                  sam_record, validate_sam)  # noqa: F401
