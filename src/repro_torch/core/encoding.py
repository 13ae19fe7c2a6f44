"""2-bit DNA base encoding (A=0, C=1, G=2, T=3) — torch twin of
``repro.core.encoding``.

Bases travel as uint8 codes in {0..3} (4 is the "N" sentinel of the
index).  The host-side string/strand helpers and the 2-bit packing
(``pack_2bit``/``unpack_2bit``) stay numpy; ``kmer_codes``
runs on tensors and carries codes as int64 (torch has no uint32 shifts
or comparisons on every device), masked to the 32 bits a k <= 16 code
needs.

The traceback op codes and the index sentinel live here too, so every
module of the port takes them from one place.
"""
from __future__ import annotations

import numpy as np
import torch

BASES = "ACGT"
_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(BASES):
    _LUT[ord(_c)] = _i
    _LUT[ord(_c.lower())] = _i

A, C, G, T = 0, 1, 2, 3
NUM_BASES = 4
BITS_PER_BASE = 2

# traceback op codes (repro.core.affine_wf) and the index sentinel base
# (repro.core.index)
OP_MATCH, OP_SUB, OP_INS, OP_DEL, OP_NONE = 0, 1, 2, 3, 4
OP_CHARS = "=XIDP"
SENTINEL = 4  # "N"-like base, never equal to a read base


def encode_str(s: str) -> np.ndarray:
    """ASCII DNA string -> uint8 codes in {0..3}. Unknown bases map to A."""
    out = _LUT[np.frombuffer(s.encode(), dtype=np.uint8)]
    return np.where(out == 255, 0, out).astype(np.uint8)


# codes -> text: ACGT for 0..3, N for the sentinel and anything above
_DECODE_CHARS = np.frombuffer(b"ACGTN", dtype=np.uint8)


def decode_to_str(codes) -> str:
    codes = np.minimum(np.asarray(codes), NUM_BASES).astype(np.uint8)
    return _DECODE_CHARS[codes].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement along the last axis (A<->T, C<->G).

    Works on single sequences or batches ``(..., L)``.  Sentinel bases
    (code >= 4) are their own complement so reference windows keep their
    never-matching property under strand flips.
    """
    codes = np.asarray(codes)
    comp = np.where(codes < NUM_BASES, (NUM_BASES - 1) - codes, codes)
    return np.ascontiguousarray(comp[..., ::-1]).astype(codes.dtype)


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack base codes (len multiple of 4 padded) into bytes, 4 bases/byte:
    base j in bits 2*(j%4) of byte j//4."""
    codes = np.asarray(codes, dtype=np.uint8)
    pad = (-len(codes)) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    c = codes.reshape(-1, 4)
    return (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)).astype(
        np.uint8
    )


def unpack_2bit(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_2bit`: the first ``n`` base codes."""
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.empty((len(packed), 4), dtype=np.uint8)
    for j in range(4):
        out[:, j] = (packed >> (2 * j)) & 0x3
    return out.reshape(-1)[:n]


def kmer_codes(seq: torch.Tensor, k: int) -> torch.Tensor:
    """All k-mer integer codes of ``seq`` (..., L) -> (..., L-k+1) int64.

    code = sum_j seq[i+j] << 2*(k-1-j)  (big-endian base order; k <= 16),
    the value ``repro.core.encoding.kmer_codes`` gives as uint32: a
    sentinel base (4) spills into the neighbouring field as it does
    there, and the final mask is the uint32 wrap.
    """
    if k > 16:
        raise ValueError("k-mer code must fit 32 bits")
    L = seq.shape[-1]
    n = L - k + 1
    s = seq.to(torch.int64)
    acc = torch.zeros(seq.shape[:-1] + (n,), dtype=torch.int64,
                      device=seq.device)
    for j in range(k):
        acc |= s[..., j : j + n] << (2 * (k - 1 - j))
    return acc & 0xFFFFFFFF
