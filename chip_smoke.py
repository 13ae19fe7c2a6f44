#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. environment: the card's name and power limit (``nvidia-smi``);
2. build: compiles the Hopper kernels of ``src/repro_torch/kernels/csrc``
   and prints nvcc's ``-Xptxas -v`` report for each;
3. kernel parity: each kernel against its plain torch version on the same
   CUDA tensors: the WF kernels on random and near-match pairs at n=150,
   eth=6, sat=32, max_ops=302 (65,536 linear, 16,384 affine distance and
   affine with direction planes, 8,192 traceback instances) and on 1,000
   pairs at n=37 and n=150 at every compiled eth (0..12); the minimizer
   scan on 65,536 random reads of 150 bases (k=12, w=30) and a ragged
   1,000 reads of 80 (k=8, w=16).
   Equality must be exact.  Times each kernel and its plain version with
   CUDA events;
4. end to end: a 64 Mb synthetic reference (GRCh38 cut to what the flat
   host-side index build handles inside this run), the port's
   ``build_index``, 131,072 reads on both strands mapped through
   ``Mapper.map`` on the compacted and the fused engines.  Checks that
   every kernel launched on each engine, that the engines agree, that the
   first chunk mapped on the plain torch backend is identical, and that
   position+strand accuracy is at least 0.95;
5. padded engine: the first 16,384 reads, one batch of 32,768 rows
   (both strands) through ``Mapper(engine="padded")``.  Checks that it
   launched the linear and the dirs-emitting affine kernel and neither
   of the other two, that it equals the compacted engine on every
   result field, and that on the first 2,048 reads the plain torch
   backend gives the same; reads/s;
6. minimizer scan: ``ops.minimizer_scan`` on the forward and reverse-
   complement encodings of the 131,072 reads (262,144 rows: what seeding
   sees), held against its plain version;
7. ``map_fastq``: the reference written as a two-contig FASTA (with a run
   of N) and the reads as a FASTQ with the port's writers, then
   ``repro_torch.launch.map_fastq.main`` in-process on each engine with
   ``--chunk-reads 16384``.  Checks that each engine's kernels launched,
   that the three SAMs are equal line for line apart from ``@PG``, that
   ``validate_sam`` passes, and that position+strand accuracy read back
   from the SAM is at least 0.95; reads/s with and without the index
   build;
8. main-path kernels: a second run of each engine keeps a copy of every
   WF kernel input; each kernel is held against its plain version and
   timed on the first batch's inputs (the compacted engine's first
   chunk; the padded batch for the affine kernel with direction planes),
   and every launch of a run is timed again on its own inputs to give
   the kernels' device time per run;
9. LM serving: the two flash-attention kernels against their plain
   version on generated inputs: the tensor-core kernel (bf16, hd 16, 32,
   64, 80 and 128) on a sweep of ragged S, batch 2, KV = H and KV < H,
   causal and bidirectional, on 32 heads of 16, 32 and 80 at S=4096 (each
   timed beside ``scaled_dot_product_attention``), on SmolLM-135M's and
   Qwen3-0.6B's heads at S=4096, with a q batch stride of 2^31 elements,
   and with k and v strided (a misaligned q must be refused); the
   CUDA-core kernel (float32) on the reference kernel test's shapes, on
   inputs off 16-byte alignment and, timed beside
   ``scaled_dot_product_attention``, on StableLM-3B's, SmolLM-135M's and
   Qwen3-0.6B's heads at S=4096; both on 360 small shapes at the edges of
   their tiles.  Planted faults (a kv tile skipped, the wrong KV head,
   zero rows) are shown to fail the bf16 check on every bf16 case.
   SmolLM-135M at full width from seeded weights: a 32,768-token prefill
   (one tensor-core launch a layer), a ``torch.profiler`` trace of one
   more (the ten largest device ops), its last-token logits against a
   prefill on the plain version and against prefills with planted
   faults, the kernel on layer 0's inputs against its plain version and
   the library's attention on the same inputs, decode against forward on
   bf16 and int8 caches, ``greedy_generate``;
10. StableLM-3B's prefill at full width (32 heads of 80, 2.8 B parameters
   from seed 0): a timed 32,768-token prefill (one launch a layer of the
   tensor-core kernel at hd=80), its profile, the kernel on layer 0's
   inputs as in phase 9, and the last-token logits of a 4,096-token
   prefill against the plain version's and the planted faults'.

Each phase prints its seconds.  The last lines are the kernels JSON line
(phases 6, 8, 9 and 10, with each kernel's bound computed from its
inputs; the flash row also holds the timed cases of phase 9, the
float32 ones under ``cuda_core_kernel``) and the contract line ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, when no CUDA device is present or anything fails.
Imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# main-path kernel shapes (MapperConfig defaults) and instance counts
N, ETH, SAT, MAX_OPS = 150, 6, 32, 302
K, W = 12, 30
R_LINEAR, R_AFFINE, R_TRACEBACK = 65_536, 16_384, 8_192
R_MINI = 65_536
# phase 3 holds each WF kernel to its plain version at every compiled eth
# on PARITY_R pairs of each read length
PARITY_R, PARITY_NS = 1000, (37, N)
# the card's peaks (H100 SXM): HBM rate from NVIDIA's data sheet.  The
# int32 rate is not in the data sheet: its 67 TFLOP/s of float32 counts an
# FMA as two ops on 128 float32 lanes per SM; Hopper has 64 int32 lanes
# per SM (white paper), so 64 x 132 SMs x 1.98 GHz = 16.7 Tops/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# int32 operations that the recurrences need, in the steady state:
#   linear, per band cell: the mismatch compare, diag+sub, up+1, left+1,
#     three mins (saturation at eth+1 included);
#   affine distance, per band cell: M1 and M2 two adds and two mins each,
#     D the sub add, three mins, the match compare and its select;
#   direction byte, per band cell: two compares and two selects for D's
#     choice, one compare each for M1 and M2, two shift-adds to pack;
#   traceback walk, per step: two for the cell's address, three to take
#     the bits apart, six for the op, the next row, diagonal and state,
#     two for the op row's address, three for the step count and the
#     loop test;
#   minimizers, per k-mer: a rolling 2-bit code (shift, or, mask) and the
#     hash (three xor-shift pairs and two multiplies); per window: a van
#     Herk / Gil-Werman sliding minimum, three (value, position) min steps
#     of a compare and two selects.
# The masks of the first eth rows and the clamps the scan makes redundant
# are left out: the kernels run them, the recurrence does not need them.
LIN_OPS_PER_CELL = 7
AFF_OPS_PER_CELL = 14
DIR_OPS_PER_CELL = 8
WALK_OPS_PER_STEP = 16
MINI_OPS_PER_KMER = 3 + 8
MINI_OPS_PER_WINDOW = 3 * 3

GENOME_BASES = 64_000_000
N_READS = 131_072
CHUNK = 16_384
PLAIN_CHECK_READS = 2_048
ACCURACY_BAR = 0.95
FIELDS = ("position", "distance", "distance2", "mapped", "strand", "ops",
          "op_count", "n_candidates")
# kernels each engine launches, and those it must not
ENGINE_KERNELS = {
    "compacted": ("linear_wf", "affine_wf_dist", "affine_traceback"),
    "fused": ("linear_wf", "affine_wf_dist", "affine_traceback"),
    "padded": ("linear_wf", "affine_wf"),
}
WF_KERNELS = ("linear_wf", "affine_wf_dist", "affine_wf", "affine_traceback")

# LM serving (phase 9) and StableLM-3B's prefill (phase 10)
LM_ARCH = "smollm-135m"
LM_BATCH, LM_SEQ = 1, 32_768    # prefill_32k's sequence; batch cut from 32
STABLELM_ARCH = "stablelm-3b"
# its logits are checked against the plain version's prefill at this S (>
# ATTN_CHUNK_THRESHOLD, so every layer runs the flash kernel): at LM_SEQ
# the plain prefill would take minutes
STABLELM_CHECK_SEQ = 4096
DEC_BATCH, DEC_PROMPT, DEC_NEW = 8, 32, 32
DEC_CHECK_SEQ = 64
# published dense peaks of the H100 SXM (NVIDIA's data sheet): the bound
# of attention is its two products at the rate of the inputs' type
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# f32: the reference kernel test's tolerance, against the plain version
# (the same function as the reference's in f32).  bf16, against the plain
# version with the kernel's arithmetic (``_flash_plain``): per element
# FLASH_REL x |plain|, since each side rounds its output to bf16 once, up
# to 2^-7 of the value apart, plus FLASH_ROW x the RMS of the element's
# row (its hd outputs): the two sum in a different order and tiling, which
# moves p's rounding to bf16 by an ulp here and there, a share of the
# row's size and not of the element's
FLASH_F32_TOL = 2e-3
FLASH_REL, FLASH_ROW = 2.0**-7, 2.0**-6
# keys a kv tile of each kernel holds (ops.flash_kernel names the kernel)
FLASH_TILE = {"flash_attention_wgmma": 128, "flash_attention": 64}
# float32, on the CUDA-core kernel: the reference kernel test's four
# shapes (tests/test_kernels.py), a ragged S (100 rows: one 128-row query
# tile, the second 64-key tile past S) and the two other head dims it is
# compiled for
FLASH_SWEEP = [(2, 128, 4, 2, 32, True, 64, 64),
               (1, 256, 8, 8, 16, True, 64, 128),
               (2, 128, 6, 2, 32, False, 32, 64),
               (1, 64, 4, 1, 64, True, 64, 32),
               (1, 100, 4, 2, 80, True, 100, 100),
               (1, 100, 4, 2, 128, False, 50, 100)]
# bf16, on the tensor-core kernel (128-row query and key tiles): hd 16, 32,
# 64, 80 and 128, each causal and bidirectional; S ragged against the
# tiles (100: one tile, its second 64-row warpgroup past S; 1,000) or
# whole (256, 384); batch 2; KV = H and KV < H.  KV >= 2 and, causal, S >
# 128, so that each planted fault changes the output
FLASH_BF16_SWEEP = [(2, 1000, 4, 2, 16, True, 1000, 500),
                    (1, 384, 4, 4, 16, True, 384, 384),
                    (2, 256, 6, 2, 16, False, 256, 128),
                    (1, 1000, 4, 4, 16, False, 1000, 1000),
                    (2, 1000, 8, 2, 32, True, 500, 1000),
                    (1, 384, 8, 8, 32, True, 384, 384),
                    (2, 256, 4, 4, 32, False, 256, 128),
                    (1, 1000, 8, 2, 32, False, 1000, 1000),
                    (2, 1000, 4, 2, 64, True, 1000, 500),
                    (1, 100, 4, 4, 64, False, 100, 100),
                    (2, 256, 6, 2, 64, False, 256, 128),
                    (2, 1000, 8, 2, 80, True, 500, 1000),
                    (1, 384, 4, 4, 80, True, 384, 384),
                    (2, 256, 6, 2, 80, False, 256, 128),
                    (1, 1000, 4, 4, 80, False, 1000, 1000),
                    (1, 1000, 8, 2, 128, True, 500, 1000),
                    (2, 1000, 8, 8, 128, False, 1000, 1000),
                    (1, 384, 8, 8, 128, True, 384, 384)]
# (H, KV, hd): SmolLM-135M and Qwen3-0.6B, at S=4096 in bf16
FLASH_LM_HEADS = [(9, 3, 64), (16, 8, 128)]
FLASH_LM_SEQ = 4096
# edges of both kernels' tiles (the tensor-core kernel: 64 rows a
# warpgroup, 128 a query or key tile; the CUDA-core kernel: 128-row query
# and 64-key tiles), each S at every head dim, in bf16 and float32, causal
# and bidirectional, with (B, H, KV) = (1, 1, 1) and (3, 6, 2); checked
# against the plain version only (with one KV head a wrong-head fault
# changes nothing)
FLASH_EDGE_SEQS = (1, 2, 63, 65, 127, 129, 255, 257, 2049)
FLASH_EDGE_HEAD_DIMS = (16, 32, 64, 80, 128)
# bf16 on the tensor-core kernel at S=4096, causal, 32/32 heads of 16, 32
# and 80 (StableLM-3B's heads; 32 those of the reduced configs), each
# checked with the planted faults and timed beside
# scaled_dot_product_attention (flash backend)
FLASH_HD16 = (1, 4096, 32, 32, 16, True, 1024, 1024)
FLASH_HD32 = (1, 4096, 32, 32, 32, True, 1024, 1024)
FLASH_HD80 = (1, 4096, 32, 32, 80, True, 1024, 1024)
FLASH_BF16_TIMED = {"hd16": FLASH_HD16, "hd32": FLASH_HD32,
                    "hd80": FLASH_HD80}
# float32 on the CUDA-core kernel at S=4096, causal: StableLM-3B's heads,
# SmolLM-135M's (9/3 of 64) and Qwen3-0.6B's (16/8 of 128), each timed
# beside scaled_dot_product_attention (the backend PyTorch picks)
FLASH_F32_TIMED = {"f32_hd80": FLASH_HD80,
                   "f32_hd64": (1, 4096, 9, 3, 64, True, 1024, 1024),
                   "f32_hd128": (1, 4096, 16, 8, 128, True, 1024, 1024)}
# timed cases of phase 9 where the kernel must take less time than
# scaled_dot_product_attention on the same inputs
FLASH_BEATS_LIBRARY = ("hd16", "hd32", "f32_hd80", "f32_hd64")
# the special-function units' exponentials (16 a clock per SM, Hopper
# white paper) at the boost clock: 132 SMs x 1.98 GHz
SFU_EXPS_PER_S = 16 * 132 * 1.98e9
# every time in this script is the least mean of TIMING_ROUNDS rounds of
# calls: one stall of the shared host inside a round of 0.2 ms calls
# would double that round's mean
TIMING_ROUNDS = 3
# words in the names of cuBLAS's and CUTLASS's matrix-product kernels, by
# which the prefill profile sums the GEMMs' device time
GEMM_KERNEL_WORDS = ("gemm", "nvjet", "cutlass", "xmma")
# last-token logits, kernel prefill against the plain version's, as a
# share of the largest |logit|: between the sound reading (2.2%: an ulp's
# difference in attention grows through 30 bf16 layers) and the subtlest
# planted fault's (a kv tile skipped, 19.7%) (PERF.md, PR 13)
LOGITS_TOL = 0.05
# decode against forward at S=DEC_CHECK_SEQ, as a share of the largest
# |logit|: the bf16 cache at the reference's decode test's 1e-3; the int8
# cache rounds each cached k and v row to steps of 1/127 of its largest
# |element|, which grows through 30 layers as the prefill's ulps do
DECODE_TOL = 1e-3
DECODE_INT8_TOL = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def pair_batch(rng, R, n, eth):
    """Random and near-match (read, window) pairs: the generator of the
    reference's kernel tests — the first half are the read embedded in
    its window with up to three substitutions."""
    s1 = rng.integers(0, 4, (R, n)).astype(np.uint8)
    s2 = rng.integers(0, 4, (R, n + 2 * eth)).astype(np.uint8)
    h = R // 2
    s2[:h, eth : eth + n] = s1[:h]
    n_sub = rng.integers(0, 4, h)
    for e in range(3):
        rows = np.flatnonzero(n_sub > e)
        cols = eth + rng.integers(0, n, len(rows))
        s2[rows, cols] = rng.integers(0, 4, len(rows))
    return s1, s2


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """ms per call of ``fn``: CUDA events around ``reps`` calls after
    ``warmup``, the least mean of TIMING_ROUNDS such rounds."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    best = math.inf
    for _ in range(TIMING_ROUNDS):
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def phase_env():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    log(f"device: {torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    info = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall, "
        f"nvcc {build.nvcc_path()}")
    for name, d in info.items():
        log(f"--- {name}: {d['seconds']:.2f} s, nvcc -Xptxas -v report:")
        log(d["log"].strip() or "(already built)")


def _compare(name, got, want):
    import torch
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max()) if g.numel() else 0)
    if err:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version, max |diff| = {err}")
    return err


def _kernels():
    """Each WF kernel's wrapper, plain version, provenance and the engine
    whose run gives its main-path row; every callable takes (s1,
    s2_window, eth, max_ops)."""
    from repro_torch.core.affine_wf import (banded_affine, banded_affine_dist,
                                            traceback)
    from repro_torch.core.linear_wf import banded_wf
    from repro_torch.kernels import ops

    def plain_tb(a, b, eth, max_ops):
        de, dm, dirs = banded_affine(a, b, eth=eth, sat=SAT)
        o, c = traceback(dirs, eth, max_ops)
        return de, dm, o, c

    return {
        "linear_wf": dict(
            R=R_LINEAR, reps=50,
            run=lambda a, b, eth, mo: ops.linear_wf(a, b, eth=eth),
            plain=lambda a, b, eth, mo: banded_wf(a, b, eth=eth),
            source="src/repro_torch/kernels/csrc/linear_wf.cu",
            replaces="src/repro/kernels/linear_wf.py:76",
            engine="compacted"),
        "affine_wf_dist": dict(
            R=R_AFFINE, reps=50,
            run=lambda a, b, eth, mo: ops.affine_wf_dist(a, b, eth=eth,
                                                         sat=SAT),
            plain=lambda a, b, eth, mo: banded_affine_dist(a, b, eth=eth,
                                                           sat=SAT),
            source="src/repro_torch/kernels/csrc/affine_wf.cu",
            replaces="src/repro/kernels/affine_wf.py:179",
            engine="compacted"),
        "affine_wf": dict(
            R=R_AFFINE, reps=20,
            run=lambda a, b, eth, mo: ops.affine_wf(a, b, eth=eth, sat=SAT),
            plain=lambda a, b, eth, mo: banded_affine(a, b, eth=eth,
                                                      sat=SAT),
            source="src/repro_torch/kernels/csrc/affine_wf.cu",
            replaces="src/repro/kernels/affine_wf.py:149",
            engine="padded"),
        "affine_traceback": dict(
            R=R_TRACEBACK, reps=20,
            run=lambda a, b, eth, mo: ops.affine_traceback(
                a, b, eth=eth, sat=SAT, max_ops=mo),
            plain=plain_tb,
            source="src/repro_torch/kernels/csrc/traceback.cu",
            replaces="src/repro/kernels/traceback.py:108",
            engine="compacted"),
    }


def bound(name, R, n, eth, max_ops, steps=0):
    """(bound_ms, bound_by): the larger of the recurrence's int32
    operations over the int32 rate and the bytes read and written once
    over the HBM rate.  ``steps``: the traceback's walk lengths summed."""
    cells = R * n * (2 * eth + 1)
    n_bytes = R * (2 * n + 2 * eth + 8)
    if name == "linear_wf":
        n_ops = LIN_OPS_PER_CELL * cells
    elif name == "affine_wf_dist":
        n_ops = AFF_OPS_PER_CELL * cells
    elif name == "affine_wf":
        n_ops = (AFF_OPS_PER_CELL + DIR_OPS_PER_CELL) * cells
        n_bytes += cells                  # one direction byte per cell
    else:
        n_ops = ((AFF_OPS_PER_CELL + DIR_OPS_PER_CELL) * cells
                 + WALK_OPS_PER_STEP * steps)
        n_bytes += R * (4 * max_ops + 4)
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def minimizer_bound(R, L, k, w):
    """(bound_ms, bound_by) of the minimizer scan: the operations listed
    above over the int32 rate against L bytes in and two int64s out per
    window over the HBM rate."""
    n_kmers = L - k + 1
    n_win = n_kmers - w + 1
    n_ops = R * (MINI_OPS_PER_KMER * n_kmers + MINI_OPS_PER_WINDOW * n_win)
    n_bytes = R * (L + 16 * n_win)
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _minimizer_plain(seqs, k, w):
    from repro_torch.core.minimizers import minimizers
    h, _, p = minimizers(seqs, k=k, w=w)
    return h, p


def phase_minimizer_parity():
    """The minimizer scan against its plain version on random reads."""
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(12)
    for R, L, k, w in ((1000, 80, 8, 16), (R_MINI, N, K, W)):
        seqs = torch.from_numpy(rng.integers(0, 4, (R, L)).astype(
            np.uint8)).cuda()
        got = ops.minimizer_scan(seqs, k=k, w=w)
        torch.cuda.synchronize()
        _compare(f"minimizer_scan R={R} L={L} k={k} w={w}", got,
                 _minimizer_plain(seqs, k, w))
        log(f"parity minimizer_scan: R={R} L={L} k={k} w={w}: "
            f"bit-identical (tolerance 0: integer outputs)")
    ms = cuda_ms(lambda: ops.minimizer_scan(seqs, k=K, w=W), 50, 3)
    plain_ms = cuda_ms(lambda: _minimizer_plain(seqs, K, W), 2, 1)
    b_ms, b_by = minimizer_bound(R_MINI, N, K, W)
    log(f"timing minimizer_scan (random reads): R={R_MINI}: {ms:.4f} "
        f"ms/call, plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{b_ms / ms:.1%} of bound")


def phase_parity():
    """Each WF kernel against its plain version on generated pairs: at
    every compiled eth (``ops.SUPPORTED_ETH``) on PARITY_R pairs of each
    of PARITY_NS read lengths, then on the main path's geometry (timed)."""
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(11)
    dev = torch.device("cuda")
    eths = ops.SUPPORTED_ETH
    for name, k in _kernels().items():
        # ragged: R off every block size, short and main-path reads, every
        # band; the traceback also with a max_ops that wraps
        cases = [(PARITY_R, n, eth, 2 * n + 2) for eth in eths
                 for n in PARITY_NS]
        if name == "affine_traceback":
            cases.append((PARITY_R, 37, 4, 40))
        cases.append((k["R"], N, ETH, MAX_OPS))
        for R, n, eth, mo in cases:
            s1, s2 = pair_batch(rng, R, n, eth)
            a, b = torch.from_numpy(s1).to(dev), torch.from_numpy(s2).to(dev)
            got = k["run"](a, b, eth, mo)
            torch.cuda.synchronize()
            _compare(f"{name} R={R} n={n} eth={eth} max_ops={mo}", got,
                     k["plain"](a, b, eth, mo))
        wrap = " (and 40 at n=37, eth=4)" if name == "affine_traceback" \
            else ""
        log(f"parity {name}: R={PARITY_R}, n in {PARITY_NS}, every eth in "
            f"{eths[0]}..{eths[-1]}, max_ops 2n+2{wrap}; R={k['R']}, "
            f"n={N}, eth={ETH}: bit-identical (tolerance 0: "
            f"integer outputs)")
        R = k["R"]
        ms = cuda_ms(lambda: k["run"](a, b, ETH, MAX_OPS), k["reps"], 3)
        plain_ms = cuda_ms(lambda: k["plain"](a, b, ETH, MAX_OPS), 2, 1)
        steps = int(got[3].sum()) if name == "affine_traceback" else 0
        b_ms, b_by = bound(name, R, N, ETH, MAX_OPS, steps)
        log(f"timing {name} (generated pairs): R={R}: {ms:.4f} ms/call "
            f"({R / ms * 1e3:,.0f} instances/s), plain {plain_ms:.2f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound")
        if name == "affine_wf":
            log(f"timing affine_wf: a contiguous (R, n, band) copy of the "
                f"direction planes, which the wrapper does not make: "
                f"{cuda_ms(lambda: got[2].contiguous(), 20, 2):.4f} ms")


class KernelInputs:
    """Keeps a copy of the inputs of every kernel launch made inside it, by
    wrapping the four WF wrappers of ``repro_torch.kernels.ops`` that
    ``core.wf_backend`` calls; the wrappers and their launch counters
    are unchanged."""

    def __init__(self):
        self.calls = {name: [] for name in WF_KERNELS}

    def __enter__(self):
        from repro_torch.kernels import ops
        self._saved = {name: getattr(ops, name) for name in self.calls}
        for name, fn in self._saved.items():
            setattr(ops, name, self._keep(name, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for name, fn in self._saved.items():
            setattr(ops, name, fn)

    def _keep(self, name, fn):
        def wrapped(s1, s2_window, **kw):
            if kw.get("eth") != ETH or kw.get("sat", SAT) != SAT:
                raise AssertionError(f"{name} called with {kw}, not the "
                                     f"main path's eth={ETH}, sat={SAT}")
            if s1.is_cuda:
                self.calls[name].append((s1.clone(), s2_window.clone(),
                                         kw.get("max_ops", MAX_OPS)))
            return fn(s1, s2_window, **kw)
        return wrapped


def _check_launches(what, engine, launches):
    """Each kernel of ``engine`` launched, and no other WF kernel."""
    for name in WF_KERNELS:
        if (launches[name] > 0) != (name in ENGINE_KERNELS[engine]):
            raise AssertionError(f"{what}: {engine} launched {name} "
                                 f"{launches[name]} times: {launches}")


def phase_e2e():
    import torch
    from repro_torch.core.index import build_index
    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pipeline import MapperConfig
    from repro_torch.data.genome import make_reference, sample_reads
    from repro_torch.kernels import ops

    log(f"end to end: reference of {GENOME_BASES:,} bases — GRCh38 "
        f"(3.1 Gb) is cut to 64 Mb because the flat index build runs on "
        f"the host inside this run's time limit; full-genome scale waits "
        f"for the sharded index")
    t0 = time.perf_counter()
    ref = make_reference(GENOME_BASES, seed=0, repeat_frac=0.02)
    t1 = time.perf_counter()
    idx = build_index(ref)
    t2 = time.perf_counter()
    log(f"reference {t1 - t0:.2f} s; build_index {t2 - t1:.2f} s: "
        f"{len(idx.uniq_kmers):,} minimizers, {len(idx.positions):,} "
        f"occurrences, segments {idx.segments.nbytes / 1e9:.3f} GB")
    rs = sample_reads(ref, N_READS, seed=1, both_strands=True)
    log(f"sample_reads: {N_READS:,} reads in "
        f"{time.perf_counter() - t2:.2f} s")

    results, runs, cfgs = {}, {}, {}
    for engine in ("compacted", "fused"):
        cfg = MapperConfig.from_index(idx, both_strands=True,
                                      chunk_reads=CHUNK, engine=engine,
                                      cigar_mode="eager")
        mapper = Mapper(idx, cfg)
        mapper.map(rs.reads[:CHUNK])       # warm-up: library load, caches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = mapper.map(rs.reads)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        _check_launches("Mapper.map", engine, launches)
        log(f"{engine}: {N_READS:,} reads in {dt:.3f} s = "
            f"{N_READS / dt:,.0f} reads/s; launches {launches}; "
            f"{res.stats['n_chunks']} chunks; candidates "
            f"{res.stats.candidates:,}, survivors {res.stats.survivors:,}, "
            f"affine instances {res.stats.affine_instances:,}; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        mapper.close()
        results[engine], cfgs[engine] = res, cfg
        runs[engine] = dict(wall_s=dt, launches=launches)
    for engine, cfg in cfgs.items():
        # the same run again, keeping every kernel's inputs (not timed)
        mapper = Mapper(idx, cfg)
        with KernelInputs() as kept:
            again = mapper.map(rs.reads)
        mapper.close()
        if not np.array_equal(again.position, results[engine].position):
            raise AssertionError(f"{engine}: a second run differs")
        runs[engine]["calls"] = kept.calls

    a, b = results["compacted"], results["fused"]
    for f in FIELDS:
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"compacted and fused differ in {f}")
    log("compacted == fused on every shared field")

    cfg_t = MapperConfig.from_index(idx, both_strands=True,
                                    chunk_reads=CHUNK, wf_backend="torch")
    t0 = time.perf_counter()
    plain = Mapper(idx, cfg_t).map(rs.reads[:CHUNK])
    log(f"first chunk on the plain torch backend: "
        f"{time.perf_counter() - t0:.2f} s")
    for f in FIELDS + ("linear_dist",):
        if not np.array_equal(getattr(plain, f), getattr(a, f)[:CHUNK]):
            raise AssertionError(f"kernel path and torch path differ in {f}")
    log("kernel path == torch path on the first chunk")

    ok = ((np.abs(a.position - rs.true_pos) <= ETH)
          & (a.strand == rs.strand))
    acc = float(ok.mean())
    log(f"accuracy (position within eth, strand right): {acc:.5f}")
    if acc < ACCURACY_BAR:
        raise AssertionError(f"accuracy {acc} below {ACCURACY_BAR}")

    cfg_s = MapperConfig.from_index(idx, both_strands=True,
                                    chunk_reads=CHUNK, stream=False)
    res_s = Mapper(idx, cfg_s).map(rs.reads)
    times = res_s.stats["stage_times_s"]
    log("stage_times_s (compacted, stream=False): "
        + json.dumps({k: round(v, 4) for k, v in times.items()}))
    if not np.array_equal(res_s.position, a.position):
        raise AssertionError("stream=False differs from stream=True")
    return runs, ref, idx, rs, a


def phase_padded(idx, rs, compacted):
    """The padded engine on the first chunk's reads: one batch of 2*CHUNK
    rows, against the compacted engine and the plain torch backend."""
    import torch
    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pipeline import MapperConfig
    from repro_torch.kernels import ops

    reads = rs.reads[:CHUNK]
    cfg = MapperConfig.from_index(idx, both_strands=True, engine="padded")
    mapper = Mapper(idx, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # index, phase 4's kept inputs
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = mapper.map(reads)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    _check_launches("Mapper.map", "padded", launches)
    log(f"padded: {CHUNK:,} reads ({2 * CHUNK:,} rows) in {dt:.3f} s = "
        f"{CHUNK / dt:,.0f} reads/s (first batch: nothing of it ran "
        f"before); launches {launches}; peak device memory "
        f"{(torch.cuda.max_memory_allocated() - held) / 1e9:.3f} GB above "
        f"the {held / 1e9:.3f} GB held before the run")
    for f in FIELDS + ("linear_dist",):
        if not np.array_equal(getattr(res, f), getattr(compacted, f)[:CHUNK]):
            raise AssertionError(f"padded and compacted differ in {f}")
    log("padded == compacted on every result field")
    cfg_t = MapperConfig.from_index(idx, both_strands=True, engine="padded",
                                    wf_backend="torch")
    t0 = time.perf_counter()
    plain = Mapper(idx, cfg_t).map(reads[:PLAIN_CHECK_READS])
    log(f"padded, first {PLAIN_CHECK_READS:,} reads on the plain torch "
        f"backend: {time.perf_counter() - t0:.2f} s")
    for f in FIELDS + ("linear_dist",):
        if not np.array_equal(getattr(plain, f),
                              getattr(res, f)[:PLAIN_CHECK_READS]):
            raise AssertionError(f"padded: kernel path and torch path "
                                 f"differ in {f}")
    log("padded: kernel path == torch path")
    with KernelInputs() as kept:
        again = mapper.map(reads)
    if not np.array_equal(again.position, res.position):
        raise AssertionError("padded: a second run differs")
    return dict(wall_s=dt, launches=launches, calls=kept.calls)


def phase_minimizer_mainpath(rs):
    """``ops.minimizer_scan`` on what seeding sees: every read's forward
    and reverse-complement encodings.  -> the kernel's JSON row."""
    import torch
    from repro_torch.core.encoding import revcomp
    from repro_torch.kernels import ops

    seqs = torch.from_numpy(np.concatenate([rs.reads, revcomp(rs.reads)])
                            ).cuda()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = ops.minimizer_scan(seqs, k=K, w=W)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["minimizer_scan"]
    if launches != 1:
        raise AssertionError(f"minimizer_scan launched {launches} times")
    err = _compare(f"minimizer_scan main path R={len(seqs)}", got,
                   _minimizer_plain(seqs, K, W))
    ms = cuda_ms(lambda: ops.minimizer_scan(seqs, k=K, w=W), 20, 3)
    plain_ms = cuda_ms(lambda: _minimizer_plain(seqs, K, W), 1, 1)
    R, L = seqs.shape
    b_ms, b_by = minimizer_bound(R, L, K, W)
    log(f"main path minimizer_scan: R={R:,} reads of {L}: bit-identical to "
        f"the plain version; {ms:.4f} ms/call ({R / ms * 1e3:,.0f} reads/s)"
        f", plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{b_ms / ms:.1%} of bound")
    return dict(name="minimizer_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/minimizer.cu",
                replaces="src/repro/kernels/minimizer.py:59",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                instances=int(R))


def _sam_accuracy(text, truth):
    """Share of records on the right contig, POS within eth and the right
    FLAG 0x10, read back from the SAM."""
    ok = 0
    for ln in text.splitlines():
        if ln.startswith("@"):
            continue
        f = ln.split("\t", 4)
        contig, pos0, strand = truth[int(f[0][4:])]
        flag = int(f[1])
        ok += (not flag & 0x4 and f[2] == contig
               and abs(int(f[3]) - 1 - pos0) <= ETH
               and bool(flag & 0x10) == bool(strand))
    return ok / len(truth)


def phase_map_fastq(ref, rs):
    """``map_fastq`` in-process on each engine, from FASTA and FASTQ files
    written by the port's writers; -> {engine: launches}."""
    import torch
    from repro_torch.data.genome import write_fasta, write_fastq
    from repro_torch.io.sam import validate_sam
    from repro_torch.kernels import ops
    from repro_torch.launch import map_fastq

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        half = GENOME_BASES // 2
        chr1 = ref[:half].copy()
        chr1[1_000_000:1_000_200] = 4          # a run of N
        fa, fq = os.path.join(work, "ref.fa"), os.path.join(work, "reads.fq")
        t0 = time.perf_counter()
        write_fasta(fa, [("chr1", chr1), ("chr2", ref[half:])])
        write_fastq(fq, rs.reads, rs.quals,
                    [f"read{i}" for i in range(N_READS)])
        log(f"map_fastq: wrote {GENOME_BASES:,} bases as two contigs and "
            f"{N_READS:,} reads in {time.perf_counter() - t0:.2f} s")
        truth = [("chr1", int(p), int(s)) if p < half else
                 ("chr2", int(p) - half, int(s))
                 for p, s in zip(rs.true_pos, rs.strand)]
        bodies, launches = {}, {}
        for engine in ("compacted", "fused", "padded"):
            out = os.path.join(work, f"{engine}.sam")
            err = io.StringIO()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc = map_fastq.main([fa, fq, "-o", out, "--engine", engine,
                                     "--chunk-reads", str(CHUNK)])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches[engine] = dict(ops.LAUNCHES)
            if rc != 0:
                raise AssertionError(f"map_fastq --engine {engine}: exit "
                                     f"{rc}\n{err.getvalue()}")
            _check_launches("map_fastq", engine, launches[engine])
            done = [ln for ln in err.getvalue().splitlines()
                    if ln.startswith("done:")][0]
            m = re.search(r"; (\d+) reads/s mapping", done)
            with open(out) as f:
                text = f.read()
            bodies[engine] = [ln for ln in text.splitlines()
                              if not ln.startswith("@PG")]
            acc = _sam_accuracy(text, truth)
            log(f"map_fastq --engine {engine}: {dt:.2f} s wall = "
                f"{N_READS / dt:,.0f} reads/s with the FASTA load and "
                f"index build, {int(m.group(1)):,} reads/s mapping and SAM "
                f"without them; accuracy from the SAM {acc:.5f}; launches "
                f"{launches[engine]}")
            log(f"  {done}")
            if acc < ACCURACY_BAR:
                raise AssertionError(f"map_fastq {engine}: accuracy {acc} "
                                     f"below {ACCURACY_BAR}")
        for engine in ("fused", "padded"):
            if bodies[engine] != bodies["compacted"]:
                raise AssertionError(f"map_fastq: the {engine} SAM differs "
                                     f"from the compacted one")
        stats = validate_sam("\n".join(bodies["compacted"]),
                             expect_reads=N_READS)
        log(f"map_fastq: the three SAMs are equal apart from @PG; "
            f"validate_sam passed: {stats['n_mapped']:,} mapped, "
            f"{stats['n_reverse']:,} reverse")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def phase_mainpath_kernels(runs):
    """Each WF kernel on the inputs the main path gave it: parity and times
    on the first batch of its engine (the compacted engine's first chunk;
    the padded batch for the kernel only the padded engine runs), and
    every launch of each engine's run timed again on its own inputs."""
    import torch
    rows = {}
    for name, k in _kernels().items():
        for engine, run in runs.items():
            calls = run["calls"][name]
            if not calls:
                continue
            per_call = [cuda_ms(lambda: k["run"](s1, s2, ETH, mo), 5, 1)
                        for s1, s2, mo in calls]
            total = sum(per_call)
            run.setdefault("kernel_ms", {})[name] = total
            log(f"main path {engine} {name}: {len(calls)} launches, "
                f"instances {[c[0].shape[0] for c in calls]}, device time "
                f"{total:.3f} ms = {total / 1e3 / run['wall_s']:.2%} of the "
                f"run's {run['wall_s']:.3f} s wall")
        main = runs[k["engine"]]
        s1, s2, mo = main["calls"][name][0]
        R, n = s1.shape
        got = k["run"](s1, s2, ETH, mo)
        torch.cuda.synchronize()
        err = _compare(f"{name} main-path R={R}", got,
                       k["plain"](s1, s2, ETH, mo))
        ms = cuda_ms(lambda: k["run"](s1, s2, ETH, mo), 20, 3)
        plain_ms = cuda_ms(lambda: k["plain"](s1, s2, ETH, mo), 1, 1)
        steps = int(got[3].sum()) if name == "affine_traceback" else 0
        b_ms, b_by = bound(name, R, n, ETH, mo, steps)
        rows[name] = dict(
            name=name, route="cuda", source=k["source"],
            replaces=k["replaces"], launches=main["launches"][name],
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, instances=int(R),
            engine=k["engine"],
            launches_by_engine={e: r["launches"][name]
                                for e, r in runs.items()},
            run_ms={e: r["kernel_ms"][name] for e, r in runs.items()
                    if name in r.get("kernel_ms", {})})
        extra = ""
        if name == "affine_wf":
            extra = (f"; a contiguous copy of its direction planes "
                     f"{cuda_ms(lambda: got[2].contiguous(), 20, 2):.4f} ms")
        log(f"main path {name}: first {k['engine']} batch, R={R}: "
            f"bit-identical to the plain version; {ms:.4f} ms/call "
            f"({R / ms * 1e3:,.0f} instances/s), plain {plain_ms:.2f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound{extra}")
    for engine, run in runs.items():
        total = sum(run["kernel_ms"].values())
        log(f"main path {engine}: kernels {total:.3f} ms of "
            f"{run['wall_s'] * 1e3:.3f} ms wall "
            f"({total / 1e3 / run['wall_s']:.2%})")
    return rows

def _close(name, got, want, tol):
    """max |got - want| over float32 views; raises unless every element
    is within tol + tol * |want| and the kernel's output is finite."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: the kernel's output is not finite")
    err = (g - w).abs()
    if bool((err > tol + tol * w.abs()).any()):
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version beyond {tol}: max |diff| = "
                             f"{float(err.max())}")
    return float(err.max())


def _flash_share(got, want):
    """(max |got - want|, the largest share of its tolerance an element
    uses): FLASH_REL x |want| + FLASH_ROW x the RMS of want's row (the hd
    outputs of one query row and head)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    tol = (FLASH_REL * w.abs() + FLASH_ROW * rms).clamp_min(1e-30)
    return float(d.max()), float((d / tol).max())


def _flash_close(name, got, want):
    """A bf16 flash output against its plain version: raises unless it is
    finite and every element within its tolerance (``_flash_share``).
    -> (max |diff|, share of the tolerance used)."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: the kernel's output is not finite")
    err, share = _flash_share(got, want)
    if share > 1:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version: max |diff| {err:.3g}, {share:.3g} x "
                             f"its tolerance")
    return err, share


def _flash_plain(q, k, v, causal, q_chunk, kv_chunk):
    """The kernel's plain version: ``_sdpa_chunked`` with its arithmetic
    (f32 scores, p rounded to v's dtype, f32 P.V sums)."""
    from repro_torch.core.attention import _sdpa_chunked
    return _sdpa_chunked(q, k, v, causal, q_chunk, kv_chunk, f32_scores=True)


def _plain_masked(q, k, v, keep, chunk=1024):
    """Attention with the kernel's arithmetic over the (query, key) pairs
    that ``keep(qpos, kpos)`` allows, one softmax over all keys per chunk
    of query rows: the body of the planted faults."""
    import torch
    from repro_torch.core.attention import NEG
    B, S, H, hd = q.shape
    KV = k.shape[2]
    kf, vf = k.float(), v.float()
    kpos = torch.arange(S, device=q.device)[None, :]
    outs = []
    for i in range(0, S, chunk):
        qb = q[:, i : i + chunk].float() * (1.0 / math.sqrt(hd))
        n = qb.shape[1]
        s = torch.einsum("bqgrd,bkgd->bgrqk",
                         qb.reshape(B, n, KV, H // KV, hd), kf)
        qpos = torch.arange(i, i + n, device=q.device)[:, None]
        kept = keep(qpos, kpos)
        s = s.masked_fill(~kept, NEG)
        # a row that keeps no key sums nothing: 0 / max(0, 1e-30) = 0
        p = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill(~kept, 0)
        o = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype).float(), vf)
        o = o / p.sum(-1).permute(0, 3, 1, 2).clamp_min(1e-30)[..., None]
        outs.append(o.to(q.dtype).reshape(B, n, H, hd))
    return torch.cat(outs, dim=1)


def _fault_tile(q, k, v, causal, q_chunk, kv_chunk):
    """A kv tile of the kernel these inputs go to skipped: causal, each row
    past the first tile misses its diagonal tile; bidirectional, every row
    misses the last tile."""
    from repro_torch.kernels import ops
    S = q.shape[1]
    tile = FLASH_TILE[ops.flash_kernel(q.dtype, q.shape[3])]
    if causal:
        def keep(qp, kp):
            return (kp <= qp) & ((kp < qp // tile * tile) | (qp < tile))
    else:
        def keep(qp, kp):
            return kp < S - tile
    return _plain_masked(q, k, v, keep)


def _fault_head(q, k, v, causal, q_chunk, kv_chunk):
    """Query head h reads KV head h // rep + 1 (mod KV)."""
    def keep(qp, kp):
        return (kp <= qp) if causal else (kp >= 0)
    return _plain_masked(q, k.roll(1, 2), v.roll(1, 2), keep)


def _fault_rows(q, k, v, causal, q_chunk, kv_chunk):
    """The rows past S/2 left zero."""
    out = _flash_plain(q, k, v, causal, q_chunk, kv_chunk)
    out[:, q.shape[1] // 2 :] = 0
    return out


# planted kernel faults, built from plain versions: each must fail the
# bf16 check on the generated S=4096 inputs and on layer 0 of the
# prefill; the first two also the prefill's logits check
FLASH_FAULTS = {"a kv tile skipped": _fault_tile,
                "the wrong KV head read": _fault_head,
                "rows past S/2 left zero": _fault_rows}
LOGITS_FAULTS = ("a kv tile skipped", "the wrong KV head read")


def _f32_share(got, want):
    """(max |got - want|, the largest share of its tolerance an element
    uses): FLASH_F32_TOL + FLASH_F32_TOL x |want|, ``_close``'s check."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), float((d / (FLASH_F32_TOL * (
        1 + want.float().abs()))).max())


def _check_faults(what, q, k, v, causal, qc, kc, want):
    """Each planted fault's max |diff| and share of the tolerance of the
    check its dtype gets (bf16: ``_flash_share``; float32: ``_f32_share``)
    on these inputs; raises if one passes."""
    import torch
    share = _flash_share if q.dtype == torch.bfloat16 else _f32_share
    got = {name: share(fault(q, k, v, causal, qc, kc), want)
           for name, fault in FLASH_FAULTS.items()}
    log(f"planted faults, {what}: " + ", ".join(
        f"{name} max |diff| {e:.3g}, {s:.3g} x the tolerance"
        for name, (e, s) in got.items()))
    passed = [name for name, (_, s) in got.items() if s <= 1]
    if passed:
        raise AssertionError(f"{what}: planted faults pass the {q.dtype} "
                             f"check: {passed}")


def _qkv_inputs(rng, B, S, H, KV, hd, dtype):
    import torch
    return [torch.from_numpy(rng.standard_normal((B, S, n, hd)).astype(
        np.float32)).cuda().to(dtype) for n in (H, KV, KV)]


def attention_flops(B, S, H, hd, causal):
    """Multiply-adds x 2 of Q.K^T and P.V over the (query, key) pairs the
    mask keeps: S(S+1)/2 per head when causal, S^2 when not."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 2 * 2 * B * H * pairs * hd


def flash_bound(q, k, causal):
    """(bound_ms, bound_by): the two products at the inputs' type's peak
    against q, k, v read and o written once over the HBM rate."""
    B, S, H, hd = q.shape
    t_ops = attention_flops(B, S, H, hd, causal) / PEAK_FLOPS[
        str(q.dtype)] * 1e3
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def exp_bound_ms(B, S, H, causal):
    """The exponentials' bound, computed: one per (query, key) pair the
    mask keeps and head, over the special-function units' rate
    (SFU_EXPS_PER_S)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return B * H * pairs / SFU_EXPS_PER_S * 1e3


def _route(dtype, hd):
    """The kernel a CUDA input should reach (the rule the wrapper's
    ``flash_kernel`` implements): the tensor-core kernel for bf16, the
    CUDA-core kernel for float32."""
    import torch
    if dtype == torch.bfloat16:
        return "flash_attention_wgmma"
    return "flash_attention"


def _flash_launch(what, q, k, v, causal, qc, kc):
    """``ops.flash_attention`` on these inputs, synchronised; raises unless
    the launch counters show one launch, of the kernel ``_route`` names."""
    import torch
    from repro_torch.kernels import ops
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=causal, q_chunk=qc,
                              kv_chunk=kc)
    torch.cuda.synchronize()
    n = {key: ops.LAUNCHES[key] - before[key]
         for key in ("flash_attention", "flash_attention_wgmma")}
    want = _route(q.dtype, q.shape[3])
    if n != {"flash_attention": 1,
             "flash_attention_wgmma": int(want == "flash_attention_wgmma")}:
        raise AssertionError(f"{what}: launches {n}, expected one of "
                             f"{want}")
    return out


def _sdpa(q, k, v, causal):
    """``scaled_dot_product_attention`` on the layers' (B, S, heads, hd)
    tensors, held to one backend: flash for bf16; efficient attention for
    float32, which the flash backend does not take, with k and v expanded
    to q's heads before the timed calls (given ``enable_gqa`` PyTorch picks
    the math backend, which forms the whole S x S score matrix).  -> (output
    in that layout, ms per call as ``cuda_ms`` takes it, the backend's
    name)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    if q.dtype == torch.bfloat16:
        name, gqa = "FLASH_ATTENTION", rep > 1
    else:
        name, gqa = "EFFICIENT_ATTENTION", False
        if rep > 1:
            kT, vT = (t.repeat_interleave(rep, 1) for t in (kT, vT))

    def call():
        return F.scaled_dot_product_attention(qT, kT, vT, is_causal=causal,
                                              enable_gqa=gqa)
    with sdpa_kernel([getattr(SDPBackend, name)]):
        out = call()
        ms = cuda_ms(call, 5, 1)
    return out.transpose(1, 2), ms, name


def _time_flash(what, q, k, v, causal, qc, kc, err):
    """The kernel these inputs go to (checked by the caller, max |diff|
    ``err``), its plain version and ``scaled_dot_product_attention``
    (``_sdpa``), timed on the same inputs, with the products' bound; the
    exponentials' computed bound is logged beside them.  -> the numbers
    for the kernels JSON row."""
    from repro_torch.kernels import ops
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                             q_chunk=qc, kv_chunk=kc), 5, 1)
    plain_ms = cuda_ms(lambda: _flash_plain(q, k, v, causal, qc, kc), 1, 1)
    _, lib_ms, backend = _sdpa(q, k, v, causal)
    b_ms, b_by = flash_bound(q, k, causal)
    e_ms = exp_bound_ms(q.shape[0], q.shape[1], q.shape[2], causal)
    kernel = ops.flash_kernel(q.dtype, q.shape[3])
    log(f"timing {what} ({kernel}): {ms:.4f} ms/call "
        f"({attention_flops(*q.shape, causal) / ms / 1e9:.2f} TFLOP/s), "
        f"plain {plain_ms:.3f} ms, scaled_dot_product_attention ({backend} "
        f"backend) {lib_ms:.4f} ms (the kernel takes {ms / lib_ms:.2f}x its "
        f"time), products' bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.2%} "
        f"of bound; the exponentials' bound {e_ms:.4f} ms (computed at "
        f"{SFU_EXPS_PER_S:.4g}/s)")
    return dict(name="flash_attention", route="cuda",
                source=f"src/repro_torch/kernels/csrc/{kernel}.cu",
                replaces="src/repro/kernels/flash_attention.py:84",
                shape=list(q.shape), dtype=str(q.dtype)[6:], causal=causal,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, library_backend=backend)


def _time_cuda_core(rng):
    """FLASH_F32_TIMED on the CUDA-core kernel: each checked against its
    plain version and the planted faults against that check, then timed
    (``_time_flash``).  -> {name: numbers}."""
    import torch
    out = {}
    for key, (B, S, H, KV, hd, causal, qc, kc) in FLASH_F32_TIMED.items():
        q, k, v = _qkv_inputs(rng, B, S, H, KV, hd, torch.float32)
        what = (f"flash_attention B={B} S={S} H={H} KV={KV} hd={hd} "
                f"causal={causal} float32")
        got = _flash_launch(what, q, k, v, causal, qc, kc)
        want = _flash_plain(q, k, v, causal, qc, kc)
        err = _close(what, got, want, FLASH_F32_TOL)
        log(f"parity {what}: max |diff| {err:.3g} (tolerance "
            f"{FLASH_F32_TOL})")
        _check_faults(what, q, k, v, causal, qc, kc, want)
        out[key] = _time_flash(what, q, k, v, causal, qc, kc, err)
        del q, k, v, got, want
    return out


def phase_flash_parity():
    """Both flash-attention kernels against their plain version on
    generated inputs, and the planted faults against the bf16 check.
    -> timings for the kernels JSON row."""
    import torch
    from repro_torch.core.attention import _sdpa_chunked
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    for B, S, H, KV, hd, causal, qc, kc in FLASH_SWEEP:
        q, k, v = _qkv_inputs(rng, B, S, H, KV, hd, torch.float32)
        what = (f"flash_attention B={B} S={S} H={H} KV={KV} hd={hd} "
                f"causal={causal} float32")
        got = _flash_launch(what, q, k, v, causal, qc, kc)
        err = _close(what, got, _flash_plain(q, k, v, causal, qc, kc),
                     FLASH_F32_TOL)
        log(f"parity {what} (CUDA cores): max |diff| {err:.3g} "
            f"(tolerance {FLASH_F32_TOL} + {FLASH_F32_TOL} x |plain|)")
    # float32 q, k, v 4 bytes past a 16-byte boundary: the CUDA-core
    # kernel's 4-byte copies
    B, S, H, KV, hd = 2, 300, 4, 2, 80
    q, k, v = (torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[
        1:].view(t.shape).copy_(t) for t in _qkv_inputs(
            rng, B, S, H, KV, hd, torch.float32))
    what = "flash_attention, float32 q, k, v off 16-byte alignment"
    err = _close(what, _flash_launch(what, q, k, v, True, S, S),
                 _flash_plain(q, k, v, True, S, S), FLASH_F32_TOL)
    log(f"parity {what} (CUDA cores): max |diff| {err:.3g}")
    timing = {}
    timed = {case: key for key, case in FLASH_BF16_TIMED.items()}
    for case in FLASH_BF16_SWEEP + list(FLASH_BF16_TIMED.values()):
        B, S, H, KV, hd, causal, qc, kc = case
        q, k, v = _qkv_inputs(rng, B, S, H, KV, hd, torch.bfloat16)
        what = (f"flash_attention B={B} S={S} H={H} KV={KV} hd={hd} "
                f"causal={causal} bfloat16")
        got = _flash_launch(what, q, k, v, causal, qc, kc)
        want = _flash_plain(q, k, v, causal, qc, kc)
        err, share = _flash_close(what, got, want)
        log(f"parity {what} ({_route(q.dtype, hd)}): max |diff| {err:.3g}, "
            f"{share:.3g} x the tolerance")
        _check_faults(what, q, k, v, causal, qc, kc, want)
        if case in timed:
            timing[timed[case]] = _time_flash(what, q, k, v, causal, qc, kc,
                                              err)
    del q, k, v, got, want
    timing.update(_time_cuda_core(rng))
    slower = {key: (timing[key]["ms"], timing[key]["library_ms"])
              for key in FLASH_BEATS_LIBRARY
              if timing[key]["ms"] >= timing[key]["library_ms"]}
    if slower:
        raise AssertionError(f"flash kernels not faster than "
                             f"scaled_dot_product_attention (ms, library "
                             f"ms): {slower}")
    S = FLASH_LM_SEQ
    for H, KV, hd in FLASH_LM_HEADS:
        for causal in (True, False):
            q, k, v = _qkv_inputs(rng, 1, S, H, KV, hd, torch.bfloat16)
            what = (f"flash_attention B=1 S={S} H={H} KV={KV} hd={hd} "
                    f"causal={causal} bfloat16")
            got = _flash_launch(what, q, k, v, causal, 1024, 1024)
            want = _flash_plain(q, k, v, causal, 1024, 1024)
            err, share = _flash_close(what, got, want)
            ref_share = _flash_share(_sdpa_chunked(
                q, k, v, causal, 1024, 1024), want)[1]
            log(f"parity {what} (tensor cores): max |diff| {err:.3g}, "
                f"{share:.3g} x the tolerance (the reference's bf16 "
                f"products: {ref_share:.3g} x)")
            _check_faults(what, q, k, v, causal, 1024, 1024, want)
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=False), 5, 1)
    b_ms, b_by = flash_bound(q, k, False)
    timing["lm4096"] = dict(shape=list(q.shape), causal=False, ms=ms,
                            bound_ms=b_ms)
    log(f"timing flash_attention {tuple(q.shape)} causal=False bfloat16 "
        f"(tensor cores): {ms:.4f} ms/call "
        f"({attention_flops(*q.shape, False) / ms / 1e9:.2f} TFLOP/s), "
        f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound")
    # 64-bit offsets, strided q: batch row 1 of q starts 2^31 elements
    # into a 4.3 GB buffer
    B, S, H, KV, hd = 2, 256, 4, 2, 64
    buf = torch.empty(2**31 + S * H * hd, dtype=torch.bfloat16,
                      device="cuda")
    q = buf.as_strided((B, S, H, hd), (2**31, H * hd, hd, 1))
    src, k, v = _qkv_inputs(rng, B, S, H, KV, hd, torch.bfloat16)
    q.copy_(src)
    what = "flash_attention, q past 2^31 elements"
    got = _flash_launch(what, q, k, v, True, 512, 512)
    err, share = _flash_close(what, got, _flash_plain(q, k, v, True, 512,
                                                      512))
    log(f"parity flash_attention with q's batch stride 2^31 elements "
        f"(tensor cores): max |diff| {err:.3g}, {share:.3g} x the "
        f"tolerance")
    del buf, q
    worst, worst_f32, n = 0.0, 0.0, 0
    for S in FLASH_EDGE_SEQS:
        for hd in FLASH_EDGE_HEAD_DIMS:
            for causal in (True, False):
                for B, H, KV in ((1, 1, 1), (3, 6, 2)):
                    for dtype in (torch.bfloat16, torch.float32):
                        q, k, v = _qkv_inputs(rng, B, S, H, KV, hd, dtype)
                        what = (f"flash_attention edge B={B} S={S} H={H} "
                                f"KV={KV} hd={hd} causal={causal} "
                                f"{str(dtype)[6:]}")
                        got = _flash_launch(what, q, k, v, causal, S, S)
                        want = _flash_plain(q, k, v, causal, S, S)
                        if dtype == torch.bfloat16:
                            worst = max(worst, _flash_close(what, got,
                                                            want)[1])
                        else:
                            worst_f32 = max(worst_f32, _close(
                                what, got, want, FLASH_F32_TOL))
                        n += 1
    log(f"parity flash_attention on {n} edge cases, S in "
        f"{FLASH_EDGE_SEQS}, hd in {FLASH_EDGE_HEAD_DIMS}: bf16 (tensor "
        f"cores) at most {worst:.3g} x the tolerance, float32 (CUDA cores) "
        f"max |diff| {worst_f32:.3g} (tolerance {FLASH_F32_TOL})")
    # k and v as slices of one (B, S, 2 KV, hd) buffer: strided, aligned
    B, S, H, KV, hd = 2, 777, 8, 2, 128
    q, kv, _ = _qkv_inputs(rng, B, S, H, 2 * KV, hd, torch.bfloat16)
    k, v = kv[:, :, :KV], kv[:, :, KV:]
    what = "flash_attention, k and v slices of one buffer"
    err, share = _flash_close(what, _flash_launch(what, q, k, v, True, S, S),
                              _flash_plain(q, k, v, True, S, S))
    log(f"parity {what} (tensor cores): max |diff| {err:.3g}, {share:.3g} "
        f"x the tolerance")
    # a q that starts 2 bytes past a 16-byte boundary must be refused
    before = dict(ops.LAUNCHES)
    bad = torch.empty(q.numel() + 8, dtype=q.dtype, device=q.device)[
        1 : 1 + q.numel()].view(q.shape)
    try:
        ops.flash_attention(bad, k, v, causal=True, q_chunk=S, kv_chunk=S)
    except ValueError as e:
        log(f"a misaligned q is refused: {e}")
    else:
        raise AssertionError("a misaligned q was not refused")
    if ops.LAUNCHES != before:
        raise AssertionError("the refused call counted a launch")
    return timing


def _profile_prefill(prefill, params, toks):
    """One prefill under ``torch.profiler``: logs the ten largest device
    ops (self device time, launches) and the flash kernel's share.  ->
    {"flash_share", "device_ms", "wall_s"}, or None when the trace holds
    no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sorted(((e.self_device_time_total, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), reverse=True)
    total = sum(us for us, _, _ in dev)
    if not total:
        log("prefill profile: the trace holds no device time")
        return None
    flash = sum(us for us, _, key in dev if "flash_wgmma_kernel" in key)
    gemm = sum(us for us, _, key in dev
               if any(w in key.lower() for w in GEMM_KERNEL_WORDS))
    log(f"prefill profile: {wall:.3f} s wall under the profiler, device "
        f"time {total / 1e3:.3f} ms ({total / 1e6 / wall:.2%} of the wall, "
        f"one stream); the flash kernel {flash / 1e3:.3f} ms = "
        f"{flash / total:.2%}, GEMM kernels {gemm / 1e3:.3f} ms = "
        f"{gemm / total:.2%}, the rest {(total - flash - gemm) / 1e3:.3f} "
        f"ms = {(total - flash - gemm) / total:.2%} of device time over "
        f"{sum(n for _, n, _ in dev):,} device ops; the ten largest:")
    for us, n, key in dev[:10]:
        log(f"  {us / 1e3:10.3f} ms {n:6d} x {us / total:7.2%}  {key[:100]}")
    return dict(flash_share=flash / total, gemm_share=gemm / total,
                device_ms=total / 1e3, wall_s=wall)


class FlashInputs:
    """Runs ``fn`` (the signature of the kernel's plain version, which
    counts no launch) in place of ``ops.flash_attention`` inside it, and
    keeps a copy of the first call's q, k, v."""

    def __init__(self, fn):
        self.fn, self.first = fn, None

    def __enter__(self):
        from repro_torch.kernels import ops
        self._saved = ops.flash_attention

        def wrapped(q, k, v, *, causal=True, q_chunk=512, kv_chunk=512):
            if self.first is None:
                self.first = (q.clone(), k.clone(), v.clone(), causal,
                              q_chunk, kv_chunk)
            return self.fn(q, k, v, causal, q_chunk, kv_chunk)
        ops.flash_attention = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention = self._saved


def _logits_diff(what, got, want):
    """-> (max |diff| / max |want|, same argmax on every row); raises if
    ``got`` is not finite."""
    import torch
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: logits not finite")
    return (float((g - w).abs().max() / w.abs().max()),
            bool((g.argmax(-1) == w.argmax(-1)).all()))


def _logits_close(what, got, want, tol):
    rel, same = _logits_diff(what, got, want)
    log(f"{what}: max |diff| / max |logit| = {rel:.4g} (tolerance {tol}), "
        f"same argmax: {same}")
    if rel > tol or not same:
        raise AssertionError(f"{what}: beyond its tolerance")
    return rel


def _draw_params(arch):
    """``arch``'s config at full width and its weights drawn on the card
    from seed 0.  -> (cfg, params)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"LM: {cfg.arch} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, norm "
        f"{cfg.norm}): {n_params:,} parameters drawn on the card from seed 0 "
        f"in {time.perf_counter() - t0:.2f} s; TF32 off for matmuls and "
        f"cuDNN")
    return cfg, params


def _timed_prefill(prefill, params, toks, cfg):
    """One prefill, timed on the host clock around a synchronise; raises
    unless it launched the tensor-core flash kernel once a layer and gave
    (B, vocab) logits.  -> (logits, seconds)."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # weights, earlier phases
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ops.LAUNCHES["flash_attention_wgmma"]
    if not launches == ops.LAUNCHES["flash_attention"] == cfg.n_layers:
        raise AssertionError(f"prefill launched flash_attention "
                             f"{ops.LAUNCHES['flash_attention']} times, "
                             f"{launches} of them the tensor-core kernel, "
                             f"not once per layer ({cfg.n_layers}) on the "
                             f"tensor cores")
    B, S = toks.shape
    if tuple(logits.shape) != (B, cfg.vocab_size):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    log(f"prefill {cfg.arch}: B={B} S={S:,} in {dt:.3f} s = "
        f"{B * S / dt:,.0f} tokens/s; flash_attention launches "
        f"{launches}, all on the tensor cores; peak device memory "
        f"{(torch.cuda.max_memory_allocated() - held) / 1e9:.3f} GB above "
        f"the {held / 1e9:.3f} GB held before it")
    return logits, dt


def _logits_check(prefill, params, toks, logits, tol):
    """The last-token ``logits`` of a kernel prefill on ``toks`` against a
    prefill on the kernel's plain version, and the prefills with planted
    faults against the same: the readings first, then the checks (sound
    within ``tol`` with the same argmax; every fault beyond it).  -> (the
    plain prefill's layer-0 flash inputs, the sound reading, {fault:
    reading})."""
    import torch
    with FlashInputs(_flash_plain) as kept:
        t0 = time.perf_counter()
        plain_logits = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        plain_dt = time.perf_counter() - t0
    rel, same = _logits_diff("prefill logits", logits, plain_logits)
    log(f"prefill at S={toks.shape[1]:,} on the plain version: "
        f"{plain_dt:.3f} s; last-token logits against the kernel prefill's: "
        f"max |diff| / max |logit| = {rel:.4g} (tolerance {tol}), same "
        f"argmax: {same}")
    fault_rel = {}
    for name in LOGITS_FAULTS:
        t0 = time.perf_counter()
        with FlashInputs(FLASH_FAULTS[name]):
            fault_rel[name] = _logits_diff(name, prefill(
                params, {"tokens": toks}), plain_logits)[0]
        dt_f = time.perf_counter() - t0
        log(f"prefill with {name} in every layer ({dt_f:.3f} s): last-token "
            f"logits max |diff| / max |logit| = {fault_rel[name]:.4g}")
    if rel > tol or not same:
        raise AssertionError("prefill logits, kernel against plain: beyond "
                             "the tolerance")
    passed = [n for n, r in fault_rel.items() if r <= tol]
    if passed:
        raise AssertionError(f"planted faults pass the logits check: "
                             f"{passed}")
    return kept.first, rel, fault_rel


def _layer0(first, what):
    """The flash kernel on one prefill's layer-0 q, k, v: against its
    plain version and the planted faults, then timed beside the plain
    version and ``scaled_dot_product_attention`` (flash backend).  -> the
    numbers for the kernels JSON row."""
    import torch
    from repro_torch.kernels import ops
    q, k, v, causal, qc, kc = first
    got = ops.flash_attention(q, k, v, causal=causal, q_chunk=qc,
                              kv_chunk=kc)
    torch.cuda.synchronize()
    want = _flash_plain(q, k, v, causal, qc, kc)
    err, share = _flash_close(f"flash_attention on layer 0 of {what}", got,
                              want)
    _check_faults(f"layer 0 of {what}", q, k, v, causal, qc, kc, want)
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                             q_chunk=qc, kv_chunk=kc), 5, 1)
    del want
    plain_ms = cuda_ms(lambda: _flash_plain(q, k, v, causal, qc, kc), 1, 1)
    bidir_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=False),
                       2, 1)
    lib, lib_ms, _ = _sdpa(q, k, v, causal)
    lib_err = float((lib.float() - got.float()).abs().max())
    b_ms, b_by = flash_bound(q, k, causal)
    log(f"flash_attention, layer 0 of {what}: q {tuple(q.shape)} "
        f"{q.dtype}: max |diff| against the plain version {err:.3g}, "
        f"{share:.3g} x the tolerance; {ms:.4f} ms/call "
        f"({attention_flops(*q.shape, causal) / ms / 1e9:.2f}"
        f" TFLOP/s), plain {plain_ms:.3f} ms, scaled_dot_product_attention "
        f"(flash backend) {lib_ms:.3f} ms (max |diff| to the kernel "
        f"{lib_err:.3g}; {lib_ms / ms:.2f}x the kernel's time), bound "
        f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.2%} of "
        f"bound; the same tensors bidirectional {bidir_ms:.3f} ms "
        f"({attention_flops(*q.shape, False) / bidir_ms / 1e9:.2f} "
        f"TFLOP/s)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, shape=list(q.shape),
                dtype=str(q.dtype)[6:], tolerance_share=share,
                bidirectional_ms=bidir_ms)


def phase_lm(timing):
    """SmolLM-135M serving at full width: prefill through the tensor-core
    flash kernel, decode, generation.  ``timing``: phase_flash_parity's.
    -> the flash kernel's JSON row."""
    import torch
    from repro_torch.models import lm, transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params = _draw_params(LM_ARCH)
    rng = np.random.default_rng(13)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        LM_BATCH, LM_SEQ))).cuda()
    prefill = lm.make_prefill_step(cfg)
    prefill(params, {"tokens": toks[:, :FLASH_LM_SEQ]})    # warm-up
    logits, dt = _timed_prefill(prefill, params, toks, cfg)
    profile = _profile_prefill(prefill, params, toks)
    # the same prefill on the plain version keeps layer 0's inputs
    first, _, _ = _logits_check(prefill, params, toks, logits, LOGITS_TOL)
    row = _layer0(first, "the SmolLM-135M prefill")

    # decode against forward, step by step over DEC_CHECK_SEQ tokens
    serve = lm.make_serve_step(cfg)
    short = toks[:1, :DEC_CHECK_SEQ]
    full, _ = transformer.forward(params, {"tokens": short}, cfg)
    for kv_quant, tol in ((False, DECODE_TOL), (True, DECODE_INT8_TOL)):
        cache = transformer.init_cache(cfg, 1, DEC_CHECK_SEQ,
                                       kv_quant=kv_quant)
        for t in range(DEC_CHECK_SEQ):
            lg, cache = serve(params, cache, short[:, t : t + 1], t)
        _logits_close(f"decode on the {'int8' if kv_quant else 'bf16'} "
                      f"cache against forward at S={DEC_CHECK_SEQ}", lg,
                      full[:, -1], tol)

    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        DEC_BATCH, DEC_PROMPT))).cuda()
    for kv_quant in (False, True):
        lm.greedy_generate(params, cfg, prompt[:, :4], 2, kv_quant=kv_quant)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lm.greedy_generate(params, cfg, prompt, DEC_NEW,
                                 kv_quant=kv_quant)
        torch.cuda.synchronize()
        dt_g = time.perf_counter() - t0
        if tuple(out.shape) != (DEC_BATCH, DEC_PROMPT + DEC_NEW) or not bool(
                (out[:, :DEC_PROMPT] == prompt).all()) or not bool(
                ((out >= 0) & (out < cfg.vocab_size)).all()):
            raise AssertionError(f"greedy_generate kv_quant={kv_quant}: "
                                 f"bad tokens {tuple(out.shape)}")
        steps = DEC_PROMPT + DEC_NEW - 1
        log(f"greedy_generate {'int8' if kv_quant else 'bf16'} cache: "
            f"B={DEC_BATCH}, {DEC_PROMPT} + {DEC_NEW} tokens in {dt_g:.3f} s"
            f" = {DEC_BATCH * DEC_NEW / dt_g:,.1f} new tokens/s, "
            f"{steps / dt_g:.1f} decode steps/s "
            f"({DEC_BATCH * steps / dt_g:,.1f} tokens/s through the decode "
            f"step)")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
                replaces="src/repro/kernels/flash_attention.py:84",
                launches=cfg.n_layers, **row,
                prefill_tokens_per_s=LM_BATCH * LM_SEQ / dt,
                prefill_profile=profile, hd128_s4096=timing["lm4096"],
                hd16_s4096=timing["hd16"], hd32_s4096=timing["hd32"],
                cuda_core_kernel={key: timing[key]
                                  for key in FLASH_F32_TIMED})


def phase_stablelm(timing):
    """StableLM-3B's prefill at full width (hd=80 on the tensor-core flash
    kernel): the timed 32,768-token prefill, its profile, the kernel on
    layer 0's inputs, and the logits against the plain version's at
    STABLELM_CHECK_SEQ.  ``timing``: phase_flash_parity's.  -> the hd=80
    kernel's JSON row."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    torch.cuda.empty_cache()
    log(f"device memory held before the model: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    cfg, params = _draw_params(STABLELM_ARCH)
    rng = np.random.default_rng(17)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        LM_BATCH, LM_SEQ))).cuda()
    prefill = lm.make_prefill_step(cfg)
    # warm-up at the full length, keeping the kernel's layer-0 inputs
    kernel = ops.flash_attention
    with FlashInputs(lambda q, k, v, c, qc, kc: kernel(
            q, k, v, causal=c, q_chunk=qc, kv_chunk=kc)) as kept:
        prefill(params, {"tokens": toks})
    _, dt = _timed_prefill(prefill, params, toks, cfg)
    profile = _profile_prefill(prefill, params, toks)
    row = _layer0(kept.first, "the StableLM-3B prefill")
    del kept
    short = toks[:, :STABLELM_CHECK_SEQ]
    logits, _ = _timed_prefill(prefill, params, short, cfg)
    _logits_check(prefill, params, short, logits, LOGITS_TOL)
    return dict(name="flash_attention_hd80", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
                replaces="src/repro/kernels/flash_attention.py:84",
                launches=cfg.n_layers, **row,
                prefill_tokens_per_s=LM_BATCH * LM_SEQ / dt,
                prefill_profile=profile, hd80_s4096=timing["hd80"])


def main() -> int:
    import torch
    t_all = time.perf_counter()
    t0 = t_all

    def phase_done(name):
        nonlocal t0
        now = time.perf_counter()
        log(f"== phase {name}: {now - t0:.2f} s")
        t0 = now

    smi = phase_env()
    phase_done("1 environment")
    phase_build()
    phase_done("2 build")
    phase_parity()
    phase_minimizer_parity()
    phase_done("3 kernel parity")
    runs, ref, idx, rs, compacted = phase_e2e()
    phase_done("4 end to end")
    runs["padded"] = phase_padded(idx, rs, compacted)
    phase_done("5 padded engine")
    mini_row = phase_minimizer_mainpath(rs)
    phase_done("6 minimizer scan")
    phase_map_fastq(ref, rs)
    phase_done("7 map_fastq")
    rows = phase_mainpath_kernels(runs)
    rows["minimizer_scan"] = mini_row
    del runs, compacted                     # the kept kernel inputs
    phase_done("8 main-path kernels")
    timing = phase_flash_parity()
    rows["flash_attention"] = phase_lm(timing)
    phase_done("9 LM serving")
    rows["flash_attention_hd80"] = phase_stablelm(timing)
    phase_done("10 StableLM-3B prefill")
    log(f"total {time.perf_counter() - t_all:.2f} s")
    log(smi)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
