"""Persistent on-disk format for the sharded genome index — a copy of
``repro.index.format``: either package reads what the other writes.

An index is one directory::

    index_dir/
      manifest.json            versioned metadata + per-file digests
      reference.2bit.npy       spacer-concatenated reference, 2-bit packed
      reference.sent.npy       sentinel bitmask (1 bit / base, little-endian)
      part0000.kmers.npy       sorted unique minimizer k-mer codes (uint32)
      part0000.offsets.npy     CSR offsets into positions (int32, n_kmers+1)
      part0000.positions.npy   global minimizer positions (int32)
      part0000.seg2bit.npy     per-occurrence segments, 2-bit packed
                               (n_occ, ceil(seg_len/4)) uint8
      part0000.segsent.npy     per-occurrence sentinel bitmask
                               (n_occ, ceil(seg_len/8)) uint8
      part0001.* ...

Everything is a raw ``.npy`` (not ``.npz``) so ``np.load(mmap_mode="r")``
gives true memmaps — opening a multi-GB index touches only the manifest
and the pages the run actually reads.  The manifest records crc32 + byte
size per file; ``open_index`` checks sizes (cheap), ``verify_index``
checks digests (full read).

Format v2 (``repro-sharded-index/2``) stores positions and CSR offsets
in the narrowest safe dtype: int32 while every position fits 2^31-1,
int64 beyond that — so GRCh38-scale (3.1 Gb) references build and load.
The ``.npy`` files are self-describing, the manifest records the chosen
``position_dtype``, and v1 indexes (always int32) still load through
the same readers.  v2 manifests additionally record ``origin``, a
virtual base offset applied to the whole reference (positions are
``origin + actual``) — the seam for sharding one genome across several
index builds, and how CI proves >= 2^31 positions without a 3 Gb
fixture.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib

import numpy as np

from ..core.index import SENTINEL

FORMAT_VERSION_V1 = "repro-sharded-index/1"
FORMAT_VERSION_V2 = "repro-sharded-index/2"
FORMAT_VERSION = FORMAT_VERSION_V2          # what new builds write
ACCEPTED_VERSIONS = (FORMAT_VERSION_V1, FORMAT_VERSION_V2)
MANIFEST_NAME = "manifest.json"

INT32_MAX = 2**31 - 1


def position_dtype(max_position: int) -> np.dtype:
    """Narrowest on-disk dtype holding positions up to ``max_position``.

    int32 while the largest position fits (v1-compatible payloads),
    int64 beyond — the v2 dtype-selection rule, applied uniformly to
    positions and CSR offsets so small builds stay compact.
    """
    return np.dtype(np.int32 if max_position <= INT32_MAX else np.int64)


def csr_offsets(counts: np.ndarray) -> np.ndarray:
    """CSR offsets from per-key counts, overflow-safe.

    The cumulative sum runs in int64 and is narrowed to int32 only when
    the total fits — an int32 cumsum wraps silently past 2^31
    occurrences-times-bytes, which is exactly the class of bug format
    v2 audits out.
    """
    offsets = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, dtype=np.int64, out=offsets[1:])
    if offsets[-1] <= INT32_MAX:
        return offsets.astype(np.int32)
    return offsets


class IndexFormatError(ValueError):
    """The directory is not a readable index of this format version."""


class IndexIntegrityError(IndexFormatError):
    """The manifest and the files on disk disagree (size or digest)."""


# ---------------------------------------------------------------------------
# 2-bit packing (byte layout shared with core.encoding.pack_2bit: base j
# occupies bits 2*(j%4) of byte j//4; sentinel mask is np.packbits
# little-endian, bit j%8 of byte j//8)
# ---------------------------------------------------------------------------

def packed_cols(n: int) -> int:
    return (n + 3) // 4


def sentinel_cols(n: int) -> int:
    return (n + 7) // 8


def pack_codes(codes: np.ndarray):
    """Pack base codes {0..4} along the last axis.

    Returns ``(two_bit, sent_bits)`` — sentinel (and any code >= 4)
    positions pack as base 0 in ``two_bit`` and set their bit in
    ``sent_bits``, so unpacking restores the exact code array.
    """
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[-1]
    pad = (-n) % 4
    if pad:
        z = np.zeros(codes.shape[:-1] + (pad,), dtype=np.uint8)
        codes = np.concatenate([codes, z], axis=-1)
    sent = codes >= 4
    two = np.where(sent, np.uint8(0), codes)
    two = two.reshape(two.shape[:-1] + (-1, 4))
    packed = (two[..., 0] | (two[..., 1] << 2) | (two[..., 2] << 4)
              | (two[..., 3] << 6)).astype(np.uint8)
    # packbits zero-pads the tail itself; the 4-alignment pad positions
    # are non-sentinel zeros, so the bit image of the first n bases is
    # exact and the column count matches sentinel_cols(n)
    sent_bits = np.packbits(sent, axis=-1,
                            bitorder="little")[..., : sentinel_cols(n)]
    return packed, sent_bits


def unpack_codes(packed: np.ndarray, sent_bits: np.ndarray,
                 n: int) -> np.ndarray:
    """Inverse of :func:`pack_codes` -> (..., n) uint8 codes {0..4}."""
    packed = np.asarray(packed, dtype=np.uint8)
    shifts = (np.arange(4, dtype=np.uint8) * 2)
    bases = ((packed[..., :, None] >> shifts) & 3)
    bases = bases.reshape(bases.shape[:-2] + (-1,))[..., :n]
    sent = np.unpackbits(np.asarray(sent_bits, dtype=np.uint8), axis=-1,
                         bitorder="little")[..., :n]
    return np.where(sent.astype(bool), np.uint8(SENTINEL),
                    bases).astype(np.uint8)


class PackedReference:
    """Random access into the packed spacer-concatenated reference.

    ``gather`` takes any-shape global base positions and returns codes,
    with out-of-range positions reading as SENTINEL — exactly the
    virtual infinite padding ``build_index`` applies before slicing
    segments, so segment extraction from disk matches the in-memory
    path byte for byte.

    ``origin`` (format v2) shifts the whole reference to a virtual base
    offset: physical byte 0 holds global position ``origin``, and
    ``length`` stays the *global* end (``origin + physical bases``), so
    gathers below ``origin`` or at/after ``length`` read as SENTINEL.
    """

    def __init__(self, packed: np.ndarray, sent_bits: np.ndarray,
                 length: int, origin: int = 0):
        self.packed = packed
        self.sent_bits = sent_bits
        self.origin = int(origin)
        self.length = int(length)

    def gather(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx)
        valid = (idx >= self.origin) & (idx < self.length)
        ci = np.clip(idx - self.origin, 0,
                     max(self.length - self.origin - 1, 0))
        b = np.asarray(self.packed[ci >> 2])
        b = (b >> ((ci & 3) * 2).astype(np.uint8)) & 3
        s = np.asarray(self.sent_bits[ci >> 3])
        s = (s >> (ci & 7).astype(np.uint8)) & 1
        ok = valid & (s == 0)
        return np.where(ok, b, np.uint8(SENTINEL)).astype(np.uint8)

    def codes(self, start: int | None = None,
              stop: int | None = None) -> np.ndarray:
        """Contiguous unpacked slice [start, stop) in global positions
        (``start`` defaults to ``origin``)."""
        start = self.origin if start is None else start
        stop = self.length if stop is None else min(stop, self.length)
        if stop <= start:
            return np.zeros(0, dtype=np.uint8)
        return self.gather(np.arange(start, stop, dtype=np.int64))


# ---------------------------------------------------------------------------
# manifest + files
# ---------------------------------------------------------------------------

def part_filenames(p: int) -> dict:
    stem = f"part{p:04d}"
    return {
        "kmers": f"{stem}.kmers.npy",
        "offsets": f"{stem}.offsets.npy",
        "positions": f"{stem}.positions.npy",
        "seg2bit": f"{stem}.seg2bit.npy",
        "segsent": f"{stem}.segsent.npy",
    }


REFERENCE_FILES = {"packed": "reference.2bit.npy",
                   "sentinel": "reference.sent.npy"}


def file_digest(path: str, chunk: int = 1 << 20) -> dict:
    crc = 0
    nbytes = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            crc = zlib.crc32(b, crc)
            nbytes += len(b)
    return {"crc32": crc & 0xFFFFFFFF, "bytes": nbytes}


def write_manifest(index_dir: str, manifest: dict) -> None:
    path = os.path.join(index_dir, MANIFEST_NAME)
    tmp = path + ".partial"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def load_manifest(index_dir: str) -> dict:
    path = os.path.join(index_dir, MANIFEST_NAME)
    if not os.path.isfile(path):
        raise IndexFormatError(
            f"{index_dir!r} is not a sharded index: no {MANIFEST_NAME} "
            f"(build one with `python -m repro_torch.launch.build_index`)")
    with open(path) as f:
        try:
            man = json.load(f)
        except json.JSONDecodeError as e:
            raise IndexFormatError(
                f"{path} is not valid JSON: {e}") from e
    got = man.get("format")
    if got not in ACCEPTED_VERSIONS:
        raise IndexFormatError(
            f"{path}: format {got!r} is not one of {ACCEPTED_VERSIONS!r}; "
            f"rebuild the index with this version of repro_torch")
    for key in ("read_len", "k", "w", "eth", "spacer", "num_partitions",
                "ref_len", "seg_len", "contigs", "partitions", "reference",
                "max_pls_per_minimizer"):
        if key not in man:
            raise IndexFormatError(f"{path}: manifest missing {key!r}")
    # v1 manifests predate these keys; their values are fixed by v1
    man.setdefault("origin", 0)
    man.setdefault("position_dtype", "int32")
    if man["position_dtype"] not in ("int32", "int64"):
        raise IndexFormatError(
            f"{path}: position_dtype {man['position_dtype']!r} is not "
            f"'int32' or 'int64'")
    if got == FORMAT_VERSION_V1 and man["origin"] != 0:
        raise IndexFormatError(
            f"{path}: format v1 indexes cannot carry a nonzero origin "
            f"({man['origin']})")
    if len(man["partitions"]) != man["num_partitions"]:
        raise IndexFormatError(
            f"{path}: manifest lists {len(man['partitions'])} partitions "
            f"but num_partitions={man['num_partitions']}")
    return man


def _check_size(index_dir: str, fname: str, meta: dict,
                problems: list) -> None:
    path = os.path.join(index_dir, fname)
    if not os.path.isfile(path):
        problems.append(f"{fname}: missing")
    elif os.path.getsize(path) != meta["bytes"]:
        problems.append(f"{fname}: {os.path.getsize(path)} bytes on disk, "
                        f"manifest says {meta['bytes']}")


def _check_crc(index_dir: str, fname: str, meta: dict,
               problems: list) -> None:
    path = os.path.join(index_dir, fname)
    if not os.path.isfile(path):
        problems.append(f"{fname}: missing")
        return
    got = file_digest(path)
    if got["bytes"] != meta["bytes"] or got["crc32"] != meta["crc32"]:
        problems.append(
            f"{fname}: crc32/bytes {got['crc32']:#010x}/{got['bytes']} "
            f"!= manifest {meta['crc32']:#010x}/{meta['bytes']}")


def _iter_files(man: dict):
    for role, fname in REFERENCE_FILES.items():
        yield fname, man["reference"][role]
    for part in man["partitions"]:
        for role, fname in part_filenames(part["id"]).items():
            yield fname, part["files"][role]


def check_integrity(index_dir: str, man: dict, *, full: bool) -> None:
    """Raise IndexIntegrityError listing every size (and, when ``full``,
    crc32) mismatch between the manifest and the files on disk."""
    problems: list = []
    for fname, meta in _iter_files(man):
        (_check_crc if full else _check_size)(index_dir, fname, meta,
                                              problems)
    if problems:
        raise IndexIntegrityError(
            f"index {index_dir!r} fails integrity check "
            f"({'crc32' if full else 'size'}):\n  "
            + "\n  ".join(problems)
            + "\n(rebuild the index or restore the files)")


@dataclasses.dataclass(frozen=True)
class PartitionFiles:
    """Loaded (or memmapped) arrays of one partition."""
    kmers: np.ndarray      # (n_kmers,) uint32, sorted
    offsets: np.ndarray    # (n_kmers+1,) int32/int64 CSR
    positions: np.ndarray  # (n_occ,) int32/int64 global minimizer positions
    seg2bit: np.ndarray    # (n_occ, ceil(seg_len/4)) uint8
    segsent: np.ndarray    # (n_occ, ceil(seg_len/8)) uint8


def _load(path: str, mmap: bool) -> np.ndarray:
    return np.load(path, mmap_mode="r" if mmap else None)


def load_partition(index_dir: str, p: int, *, mmap: bool) -> PartitionFiles:
    names = part_filenames(p)
    return PartitionFiles(
        **{role: _load(os.path.join(index_dir, fname), mmap)
           for role, fname in names.items()})


def load_reference(index_dir: str, man: dict, *,
                   mmap: bool) -> PackedReference:
    packed = _load(os.path.join(index_dir, REFERENCE_FILES["packed"]), mmap)
    sent = _load(os.path.join(index_dir, REFERENCE_FILES["sentinel"]), mmap)
    return PackedReference(packed, sent, man["ref_len"],
                           origin=man.get("origin", 0))
