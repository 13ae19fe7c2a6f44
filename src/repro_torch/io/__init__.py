"""Output formats: END-aligned traceback ops as CIGAR strings."""
from .cigar import (cigar_from_ops, cigar_query_len, cigar_ref_len,
                    parse_cigar)  # noqa: F401
