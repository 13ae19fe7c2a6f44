"""Streamed out-of-core construction of the sharded genome index — the
twin of ``repro.index.build``, writing the same files byte for byte.

Two phases, both with host memory bounded by the tile size (plus one
partition's occurrence list), never by the genome:

**Phase 1 — scan.**  The FASTA streams in bounded chunks
(``io.fasta.stream_fasta``); contigs are virtually concatenated with
``spacer`` SENTINEL bases as ``io.fasta.load_reference`` does.  A rolling
buffer walks the virtual sequence in ``tile_bp`` tiles with a ``w-1``-base
left halo and ``w+k-2``-base right halo; occurrences are kept only when
their position falls inside the tile, so the union over tiles is exactly
the flat occurrence set.  Each tile's window minimizers come from
``core.wf_backend.minimizers`` on ``device`` (``core.index._scan_tile``'s
rows): the minimizer kernel, one launch a tile, on ``backend="cuda"``,
the plain version on ``"torch"``.  Each occurrence is routed to partition
``hash32(kmer) % P`` and appended to that partition's spill file as a
``uint64 (kmer << pos_bits) | pos`` key, ``pos_bits = 64 - (2*k + 1)``
(k-mer codes spanning the sentinel base 4 carry one bit past 2-bit
packing).  The 2-bit packed reference is written alongside.

**Phase 2 — finalize** (host numpy, as the reference).  Per partition:
``np.unique`` the spilled keys (dedup + (kmer, pos) sort), cap
hyper-repetitive minimizers at ``max_pls_per_minimizer`` occurrences
(first by position), emit the CSR, and cut the packed segments from the
packed reference in bounded batches.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.index import SENTINEL, _scan_tile, validate_geometry
from ..io.fasta import Contig, stream_fasta
from ..obs import registry as _metrics
from ..obs import tracing as _tracing
from . import format as fmt
from .npscan import np_hash32

_INT32_MAX = fmt.INT32_MAX


def _validate_partitions(num_partitions: int) -> None:
    p = num_partitions
    if not isinstance(p, (int, np.integer)) or p < 1 or (p & (p - 1)):
        raise ValueError(
            f"num_partitions={p!r}: partition count must be a power of two "
            f">= 1 — partitions map onto mesh shards and pow-2 request "
            f"buckets, and hash32(kmer) % P only spreads hash bits evenly "
            f"for pow-2 P")


class _PackedRefWriter:
    """Incremental 2-bit + sentinel-bit reference writer.

    Accepts arbitrary-length code chunks; packs and flushes in
    8-base-aligned blocks (8 = lcm of the 4-codes/byte and 8-bits/byte
    layouts) with a small carry, so the byte image equals
    ``format.pack_codes`` over the whole sequence.
    """

    def __init__(self, codes_path: str, sent_path: str):
        self._fc = open(codes_path, "wb")
        self._fs = open(sent_path, "wb")
        self._pending = np.zeros(0, np.uint8)
        self.length = 0

    def write(self, codes: np.ndarray) -> None:
        codes = np.asarray(codes, np.uint8)
        self.length += len(codes)
        buf = (np.concatenate([self._pending, codes])
               if len(self._pending) else codes)
        n8 = (len(buf) // 8) * 8
        if n8:
            packed, sent = fmt.pack_codes(buf[:n8])
            self._fc.write(packed.tobytes())
            self._fs.write(sent.tobytes())
        self._pending = buf[n8:].copy()

    def close(self) -> None:
        if len(self._pending):
            packed, sent = fmt.pack_codes(self._pending)
            self._fc.write(packed.tobytes())
            self._fs.write(sent.tobytes())
            self._pending = np.zeros(0, np.uint8)
        self._fc.close()
        self._fs.close()


class _SpillWriter:
    """Append-only partition spill files behind bounded write buffers:
    payloads drain as one sequential append once ``flush_bytes`` is
    buffered (or at close)."""

    def __init__(self, paths: list, flush_bytes: int = 1 << 18):
        self._files = [open(p, "wb") for p in paths]
        self._bufs: list = [[] for _ in paths]
        self._buffered = [0] * len(paths)
        self.flush_bytes = int(flush_bytes)
        self.spill_bytes = 0
        self.spill_writes = 0

    def append(self, p: int, payload: bytes) -> None:
        self._bufs[p].append(payload)
        self._buffered[p] += len(payload)
        if self._buffered[p] >= self.flush_bytes:
            self._drain(p)

    def _drain(self, p: int) -> None:
        if not self._buffered[p]:
            return
        blob = b"".join(self._bufs[p])
        self._files[p].write(blob)
        self.spill_bytes += len(blob)
        self.spill_writes += 1
        self._bufs[p] = []
        self._buffered[p] = 0

    def close(self) -> None:
        for p in range(len(self._files)):
            self._drain(p)
            self._files[p].close()


def _finalize_npy(payload_path: str, out_path: str, dtype,
                  shape: tuple) -> None:
    """Wrap a raw little-endian payload file as a valid ``.npy``."""
    header = {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
              "fortran_order": False, "shape": shape}
    with open(out_path, "wb") as out:
        np.lib.format.write_array_header_1_0(out, header)
        with open(payload_path, "rb") as src:
            while True:
                block = src.read(1 << 20)
                if not block:
                    break
                out.write(block)
    os.remove(payload_path)


class _TileScanner:
    """Rolling-buffer tile walk over the virtual concatenated reference;
    each tile's window minimizers in one ``_scan_tile`` call on
    ``device`` (one minimizer-kernel launch on ``backend="cuda"``)."""

    def __init__(self, *, k: int, w: int, tile_bp: int, emit,
                 device: torch.device, backend: str, origin: int = 0):
        self.k, self.w, self.tile = k, w, tile_bp
        self.emit = emit                      # emit(packed_u64_occurrences)
        self.device, self.backend = device, backend
        # sentinel-spanning k-mers (base code 4) need 2k+1 bits, not 2k
        self.pos_bits = np.uint64(64 - (2 * k + 1))
        self.origin = origin                  # global pos of physical base 0
        self.buf = np.zeros(0, np.uint8)
        self.buf_start = origin               # global pos of buf[0]
        self.t0 = origin                      # next tile start
        self.tiles = 0

    def _buf_end(self) -> int:
        return self.buf_start + len(self.buf)

    def _minimizers(self, window: np.ndarray):
        """Distinct window minimizers of ``window``: (k-mer codes, k-mer
        starts), int64 numpy.  A minimizer's start never decreases as
        the window slides, so repeats are adjacent and are dropped on the
        device before the copy to the host."""
        k, w = self.k, self.w
        n_win = len(window) - (w + k - 1) + 1
        km, pos = _scan_tile(window, 0, n_win, k, w, self.device,
                             self.backend)
        keep = torch.ones_like(pos, dtype=torch.bool)
        keep[1:] = pos[1:] != pos[:-1]
        return km[keep].cpu().numpy(), pos[keep].cpu().numpy()

    def _scan(self, t1: int) -> None:
        k, w = self.k, self.w
        lo = max(self.origin, self.t0 - (w - 1))
        hi = min(self._buf_end(), t1 + w + k - 2)
        window = self.buf[lo - self.buf_start: hi - self.buf_start]
        if len(window) >= w + k - 1:
            kmer, pos = self._minimizers(window)
            pos_g = pos + lo
            keep = (pos_g >= self.t0) & (pos_g < t1)
            packed = ((kmer[keep].astype(np.uint64) << self.pos_bits)
                      | pos_g[keep].astype(np.uint64))
            self.emit(np.unique(packed))
        self.tiles += 1
        self.t0 = t1
        # drop bases the next tile's left halo no longer needs
        keep_from = max(self.origin, self.t0 - (w - 1))
        if keep_from > self.buf_start:
            self.buf = self.buf[keep_from - self.buf_start:].copy()
            self.buf_start = keep_from

    def feed(self, codes: np.ndarray) -> None:
        if len(codes):
            self.buf = (np.concatenate([self.buf, codes])
                        if len(self.buf) else np.asarray(codes, np.uint8))
        # a tile is ready once its right halo is fully buffered
        while self._buf_end() >= self.t0 + self.tile + self.w + self.k - 2:
            self._scan(self.t0 + self.tile)

    def finish(self, total_len: int) -> None:
        while self.t0 < total_len:
            self._scan(min(self.t0 + self.tile, total_len))


def _realign(src: np.ndarray, byte0: np.ndarray, shift: np.ndarray,
             cols: int, n: int, per_byte: int) -> np.ndarray:
    """Rows of ``cols`` bytes of the bit stream ``src`` (``per_byte``
    items a byte, item j in the low bits first), row i starting
    ``shift[i]`` bits into byte ``byte0[i]``; bits past the row's ``n``
    items cleared, as ``pack_codes`` leaves them."""
    idx = np.minimum(byte0[:, None] + np.arange(cols + 1), len(src) - 1)
    v = np.asarray(src[idx]).astype(np.uint16)
    out = ((v[:, :-1] | (v[:, 1:] << np.uint16(8)))
           >> shift[:, None].astype(np.uint16)).astype(np.uint8)
    tail = n - (cols - 1) * per_byte          # items in the last byte
    if tail < per_byte:
        out[:, -1] &= np.uint8((1 << (tail * 8 // per_byte)) - 1)
    return out


def _packed_segments(ref: fmt.PackedReference, starts: np.ndarray,
                     seg_len: int):
    """The segments [s, s + seg_len) at global starts ``starts``, packed:
    ``format.pack_codes(ref.gather(starts[:, None] + arange(seg_len)))``
    byte for byte.  A segment inside the reference is its packed bytes
    realigned; one that reaches past either end (SENTINEL there) takes
    the gather."""
    pc, sc = fmt.packed_cols(seg_len), fmt.sentinel_cols(seg_len)
    q = starts.astype(np.int64) - ref.origin
    inside = (q >= 0) & (q + seg_len <= ref.length - ref.origin)
    pk = np.empty((len(q), pc), np.uint8)
    sb = np.empty((len(q), sc), np.uint8)
    if inside.any():
        qi = q[inside]
        pk[inside] = _realign(ref.packed, qi >> 2, (qi & 3) * 2, pc,
                              seg_len, 4)
        sb[inside] = _realign(ref.sent_bits, qi >> 3, qi & 7, sc, seg_len, 8)
    if not inside.all():
        idx = (starts[~inside, None].astype(np.int64)
               + np.arange(seg_len, dtype=np.int64))
        pk[~inside], sb[~inside] = fmt.pack_codes(ref.gather(idx))
    return pk, sb


def build_sharded_index(fasta, out_dir: str, *, num_partitions: int = 4,
                        tile_bp: int = 1 << 20, read_len: int = 150,
                        k: int = 12, w: int = 30, eth: int = 6,
                        max_pls_per_minimizer: int = 256,
                        spacer: int | None = None, overwrite: bool = False,
                        origin: int = 0, format_version: int = 2,
                        progress=None, device=None, backend: str = "cuda"):
    """Build a persistent sharded index directory from a FASTA, streamed
    — ``repro.index.build_sharded_index``, the same files byte for byte
    (the manifest's ``build.wall_s`` apart).

    Returns the built index opened via ``open_index`` (mmap).  ``spacer``
    defaults to ``read_len + 2*eth``, the inter-contig gap ``map_fastq``
    uses.  ``origin`` (format v2 only) places the reference at a virtual
    global base offset: every recorded position and contig offset is
    ``origin + actual``, and ``ref_len`` in the manifest is the global
    end.  ``format_version=1`` writes a strict v1 index (int32 payloads,
    the 2^31 refusal, no origin).

    The tiles' minimizer scan runs on ``device`` (the card unless asked
    otherwise), through the minimizer kernel on ``backend="cuda"`` and
    the plain version on ``"torch"`` (``core.wf_backend.minimizers``).
    """
    validate_geometry(read_len=read_len, k=k, w=w, eth=eth)
    _validate_partitions(num_partitions)
    if format_version not in (1, 2):
        raise ValueError(f"format_version={format_version!r}: this builder "
                         f"writes format v1 or v2")
    if origin < 0:
        raise ValueError(f"origin={origin} must be >= 0")
    if origin and format_version == 1:
        raise ValueError(
            f"origin={origin}: format v1 has no origin field; build with "
            f"format_version=2")
    if tile_bp < w + k - 1:
        raise ValueError(
            f"tile_bp={tile_bp}: a tile must cover at least one minimizer "
            f"window (w + k - 1 = {w + k - 1} bases)")
    if spacer is None:
        spacer = read_len + 2 * eth
    if spacer < 0:
        raise ValueError(f"spacer={spacer} must be >= 0")
    device = resolve_device(device)
    P = int(num_partitions)
    # spill keys pack (kmer, position) into one u64; k-mer codes take
    # 2k+1 bits (sentinel base 4 carries past 2-bit packing), so k <= 16
    # (geometry) guarantees at least 31 position bits
    pos_bits = 64 - (2 * k + 1)
    max_pos = (1 << pos_bits) - 1
    say = progress if progress is not None else (lambda _msg: None)

    os.makedirs(out_dir, exist_ok=True)
    if not overwrite and os.path.isfile(
            os.path.join(out_dir, fmt.MANIFEST_NAME)):
        raise ValueError(
            f"{out_dir!r} already holds an index (manifest.json exists); "
            f"pass overwrite=True / --force to rebuild in place")

    t_start = time.perf_counter()
    spill_paths = [os.path.join(out_dir, f".spill{p:04d}.u64")
                   for p in range(P)]
    spills = _SpillWriter(spill_paths)
    n_spilled = np.zeros(P, dtype=np.int64)
    shift = np.uint64(pos_bits)

    def emit(packed_occ: np.ndarray) -> None:
        if not len(packed_occ):
            return
        part = (np_hash32((packed_occ >> shift).astype(np.uint32))
                % np.uint32(P)).astype(np.int64)
        order = np.argsort(part, kind="stable")
        sorted_occ, sorted_part = packed_occ[order], part[order]
        counts = np.bincount(sorted_part, minlength=P)
        bounds = np.concatenate([[0], np.cumsum(counts)])
        for p in np.nonzero(counts)[0]:
            spills.append(p, sorted_occ[bounds[p]: bounds[p + 1]].tobytes())
        n_spilled[:] += counts   # in-place: n_spilled is closed over

    ref_codes_payload = os.path.join(out_dir, ".reference.2bit.payload")
    ref_sent_payload = os.path.join(out_dir, ".reference.sent.payload")
    writer = _PackedRefWriter(ref_codes_payload, ref_sent_payload)
    scanner = _TileScanner(k=k, w=w, tile_bp=tile_bp, emit=emit,
                           device=device, backend=backend, origin=origin)

    def feed(codes: np.ndarray) -> None:
        writer.write(codes)
        scanner.feed(codes)

    # -- phase 1: stream contigs through the scanner ----------------------
    t_scan = time.perf_counter()
    contigs: list[Contig] = []
    cur_name, cur_len, cur_has_acgt = None, 0, False

    def close_contig() -> None:
        nonlocal cur_name, cur_len, cur_has_acgt
        if cur_len == 0:
            raise ValueError(f"FASTA contig {cur_name!r} has no sequence")
        if not cur_has_acgt:
            raise ValueError(f"FASTA contig {cur_name!r} has only non-ACGT "
                             f"(sentinel) bases")
        contigs.append(Contig(name=cur_name, length=cur_len,
                              offset=origin + writer.length - cur_len))
        say(f"contig {cur_name}: {cur_len} bp "
            f"(genome so far {writer.length} bp, {scanner.tiles} tiles)")
        cur_name, cur_len, cur_has_acgt = None, 0, False

    chunk_bp = max(tile_bp, w + k)
    for name, codes, is_last in stream_fasta(fasta, max_chunk=chunk_bp):
        if cur_name is None:
            if contigs:          # inter-contig spacer, as load_reference
                feed(np.full(spacer, SENTINEL, dtype=np.uint8))
            cur_name = name
        cur_len += len(codes)
        cur_has_acgt |= bool((codes != SENTINEL).any())
        feed(codes)
        if is_last:
            close_contig()
    if not contigs:
        raise ValueError("empty FASTA: no records (or none usable)")
    ref_len = origin + writer.length     # global end position
    if format_version == 1 and ref_len > _INT32_MAX:
        raise ValueError(
            f"reference is {ref_len} bases after spacer concatenation; "
            f"index format v1 stores int32 positions (max {_INT32_MAX}). "
            f"Build with format_version=2 (the default) for int64 "
            f"positions.")
    if ref_len - 1 > max_pos:
        raise ValueError(
            f"reference ends at global position {ref_len - 1} but the "
            f"spill keys hold {pos_bits} position bits at k={k} (max "
            f"{max_pos}); lower origin or use a smaller k — smaller "
            f"k-mers leave more position bits")
    scanner.finish(ref_len)
    writer.close()
    spills.close()
    _finalize_npy(ref_codes_payload,
                  os.path.join(out_dir, fmt.REFERENCE_FILES["packed"]),
                  np.uint8, (fmt.packed_cols(writer.length),))
    _finalize_npy(ref_sent_payload,
                  os.path.join(out_dir, fmt.REFERENCE_FILES["sentinel"]),
                  np.uint8, (fmt.sentinel_cols(writer.length),))
    say(f"scan done: {ref_len} bp, {scanner.tiles} tiles, "
        f"{int(n_spilled.sum())} spilled occurrences "
        f"({spills.spill_bytes} spill bytes in {spills.spill_writes} "
        f"writes)")
    tr = _tracing.ACTIVE
    if tr is not None:
        tr.add("index_scan", t_scan, time.perf_counter(),
               {"tiles": int(scanner.tiles), "ref_len": int(ref_len)})
    reg = _metrics.ACTIVE
    if reg is not None:
        reg.counter("repro_index_tiles_total").inc(int(scanner.tiles))
        reg.counter("repro_index_spilled_occurrences_total").inc(
            int(n_spilled.sum()))
        reg.counter("repro_index_spill_bytes_total").inc(
            int(spills.spill_bytes))

    # -- phase 2: finalize partitions from spills --------------------------
    man_ref = {role: fmt.file_digest(os.path.join(out_dir, fname))
               for role, fname in fmt.REFERENCE_FILES.items()}
    packed_ref = fmt.load_reference(
        out_dir, {"ref_len": ref_len, "origin": origin}, mmap=True)
    pos_dtype = fmt.position_dtype(ref_len - 1)
    pad = read_len + eth - k
    seg_len = 2 * (read_len + eth) - k
    seg_batch = max(16, tile_bp // max(seg_len, 1))
    parts_meta = []
    total_occ = 0
    dropped_pls = 0
    for p in range(P):
        t_part = time.perf_counter()
        data = np.fromfile(spill_paths[p], dtype=np.uint64)
        os.remove(spill_paths[p])
        u = np.unique(data)       # dedup (defensive) + (kmer, pos) sort
        del data
        kmers = (u >> shift).astype(np.uint32)
        pos = (u & np.uint64(max_pos)).astype(np.int64)
        del u
        # cap hyper-repetitive minimizers: keep the first
        # max_pls_per_minimizer occurrences by position (flat-build rule)
        uniq, starts, counts = np.unique(kmers, return_index=True,
                                         return_counts=True)
        cap = max_pls_per_minimizer
        keep = np.ones(len(kmers), dtype=bool)
        for s, c in zip(starts[counts > cap], counts[counts > cap]):
            keep[s + cap: s + c] = False
        dropped_pls += int((~keep).sum())
        kmers, pos = kmers[keep], pos[keep]
        uniq, counts = np.unique(kmers, return_counts=True)
        offsets = fmt.csr_offsets(counts)
        n_occ = len(pos)
        total_occ += n_occ

        names = fmt.part_filenames(p)
        np.save(os.path.join(out_dir, names["kmers"]),
                uniq.astype(np.uint32))
        np.save(os.path.join(out_dir, names["offsets"]), offsets)
        np.save(os.path.join(out_dir, names["positions"]),
                pos.astype(pos_dtype))
        seg_shape = (n_occ, fmt.packed_cols(seg_len))
        sent_shape = (n_occ, fmt.sentinel_cols(seg_len))
        seg_path = os.path.join(out_dir, names["seg2bit"])
        sent_path = os.path.join(out_dir, names["segsent"])
        if n_occ == 0:
            np.save(seg_path, np.zeros(seg_shape, np.uint8))
            np.save(sent_path, np.zeros(sent_shape, np.uint8))
        else:
            seg_mm = np.lib.format.open_memmap(
                seg_path, mode="w+", dtype=np.uint8, shape=seg_shape)
            sent_mm = np.lib.format.open_memmap(
                sent_path, mode="w+", dtype=np.uint8, shape=sent_shape)
            for b0 in range(0, n_occ, seg_batch):
                b1 = min(b0 + seg_batch, n_occ)
                seg_mm[b0:b1], sent_mm[b0:b1] = _packed_segments(
                    packed_ref, pos[b0:b1] - pad, seg_len)
            seg_mm.flush()
            sent_mm.flush()
            del seg_mm, sent_mm
        parts_meta.append({
            "id": p,
            "n_kmers": int(len(uniq)),
            "n_occurrences": int(n_occ),
            "files": {role: fmt.file_digest(os.path.join(out_dir, fname))
                      for role, fname in names.items()},
        })
        say(f"partition {p}/{P}: {len(uniq)} kmers, {n_occ} occurrences")
        tr = _tracing.ACTIVE
        if tr is not None:
            tr.add("index_partition", t_part, time.perf_counter(),
                   {"partition": p, "occurrences": int(n_occ)})
        reg = _metrics.ACTIVE
        if reg is not None:
            reg.counter("repro_index_partitions_total").inc()
            reg.counter("repro_index_occurrences_total").inc(int(n_occ))

    wall_s = time.perf_counter() - t_start
    manifest = {
        "format": (fmt.FORMAT_VERSION_V1 if format_version == 1
                   else fmt.FORMAT_VERSION_V2),
        "read_len": read_len, "k": k, "w": w, "eth": eth,
        "spacer": spacer,
        "max_pls_per_minimizer": max_pls_per_minimizer,
        "num_partitions": P,
        "ref_len": int(ref_len),
        "seg_len": int(seg_len),
        "contigs": [{"name": c.name, "length": c.length, "offset": c.offset}
                    for c in contigs],
        "reference": man_ref,
        "partitions": parts_meta,
        "build": {
            "tile_bp": int(tile_bp),
            "tiles": int(scanner.tiles),
            "n_occurrences": int(total_occ),
            "spilled_occurrences": int(n_spilled.sum()),
            "spill_bytes": int(spills.spill_bytes),
            "spill_writes": int(spills.spill_writes),
            "dropped_pls": int(dropped_pls),
            "wall_s": wall_s,
        },
    }
    if format_version == 2:
        manifest["origin"] = int(origin)
        manifest["position_dtype"] = str(pos_dtype)
    fmt.write_manifest(out_dir, manifest)
    say(f"wrote {out_dir}: {P} partitions, {total_occ} occurrences, "
        f"{spills.spill_bytes} spill bytes, "
        f"{wall_s:.2f}s ({writer.length / max(wall_s, 1e-9):.0f} bases/s)")
    from .sharded import open_index
    return open_index(out_dir)
