#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. environment: the card's name and power limit (``nvidia-smi``);
2. build: compiles the Hopper kernels of ``src/repro_torch/kernels/csrc``
   and prints nvcc's ``-Xptxas -v`` report for each (``phase_sass``, which
   the full run does not call, counts the linear and traceback kernels'
   SASS loops);
3. kernel parity: each kernel against its plain torch version on the same
   CUDA tensors: the WF kernels on random and near-match pairs at n=150,
   eth=6, sat=32, max_ops=302 (65,536 linear, 16,384 affine distance and
   affine with direction planes, 8,192 traceback instances) and on 1,000
   pairs at n=37 and n=150 at every compiled eth (0..12); the linear and
   traceback kernels also on reads no longer than the band and just past
   it (n in 1, eth, eth+1, 2*eth+1) at every eth, with SENTINEL bytes and
   bytes 0..255 in reads and windows, and at their main-path batch (the
   compacted engine's chunk of 1,048,576 instances, its 16,384 winners);
   the traceback at max_ops 1, 3 and 2n+2 in each case and on 20 reads,
   fewer than a block holds; the minimizer scan, hashes and k-mer codes,
   on 65,536 random reads of 150 bases (k=12, w=30), a ragged 1,000
   reads of 80 (k=8, w=16), bytes 0..255 and SENTINEL, k=16, w=1, rows
   of exactly one window, 20 rows and one, and the index build's rows.
   Equality must be exact.  Times each kernel and its plain version with
   CUDA events (the minimizer scan at seeding's chunk of 32,768 rows and
   at 262,144);
4. end to end: a 64 Mb synthetic reference (GRCh38 cut to what the flat
   host-side index build handles inside this run), the port's
   ``build_index`` (the minimizer kernel once a tile; its first tile
   timed on the kernel and on the plain route), 131,072 reads on both
   strands mapped through ``Mapper.map`` on the compacted and the fused
   engines.  Checks that every kernel launched on each engine (the
   minimizer scan once a chunk), that the engines agree, that the first
   chunk mapped on the plain torch backend is identical, and that
   position+strand accuracy is at least 0.95;
5. padded engine: the first 16,384 reads, one batch of 32,768 rows
   (both strands) through ``Mapper(engine="padded")``.  Checks that it
   launched the linear and the dirs-emitting affine kernel and the
   minimizer scan once, and neither of the other two, that it equals the
   compacted engine on every result field, and that on the first 2,048
   reads the plain torch backend gives the same; reads/s;
6. minimizer scan on generated input: ``ops.minimizer_scan`` on the
   forward and reverse-complement encodings of the 131,072 reads in one
   call (262,144 rows), both routes held against the plain version;
7. ``map_fastq``: the reference written as a two-contig FASTA (with a run
   of N) and the reads as a FASTQ with the port's writers, then
   ``repro_torch.launch.map_fastq.main`` in-process on each engine with
   ``--chunk-reads 16384``, and on the first 16,384 reads with
   ``--wf-backend torch``.  Checks that each engine's kernels launched
   (the minimizer scan once a tile of the index build and once a chunk),
   that the three SAMs and the plain route's are equal line for line
   apart from ``@PG``, that ``validate_sam`` passes, and that
   position+strand accuracy read back from the SAM is at least 0.95;
   reads/s with and without the index build;
7b. paired-end: 65,536 FR pairs of 150-base mates (insert 350 +- 30, 2%
   of R2 mates random sequence) on phase 4's reference and index.
   ``Mapper.map_pairs`` + ``resolve_pairs`` on the compacted and fused
   engines: every kernel of each engine launched (the minimizer scan
   once a chunk), equal ``PairResolution``s, proper-pair accuracy at
   least 0.97 over the pairs with a real R2, no junk mate rescued.  Mate
   rescue at scale: the R2 mates of the first 256 pairs that resolved
   right with an R2 within the rescue's threshold (affine distance at
   most eth) unmapped, all rescued within 2 bases on the right strand with
   MAPQ capped by the anchor's, through ``affine_wf_dist`` alone (held
   against its plain version on the rescue's rows, and timed); the first
   chunk resolved on ``wf_backend="torch"`` gives the same resolution
   with no kernel launched.  ``map_fastq --r1 --r2`` on all pairs
   (``validate_sam`` with MAPQ, accuracy from the SAM, the minimizer
   scan once an index tile and once an engine chunk), and on the first
   16,384 pairs ``--engine fused``, ``--engine padded``,
   ``--interleaved`` and ``--wf-backend torch``, each SAM equal to the
   header and first records of the full one apart from ``@PG``; pairs/s,
   the rescue's rows and wall time, reads/s with and without the index
   build;
8. main-path kernels: a second run of each engine keeps a copy of every
   mapper kernel input; each kernel is held against its plain version and
   timed on the first batch's inputs (the compacted engine's first
   chunk; the padded batch for the affine kernel with direction planes),
   and every launch of a run (phase 7b's paired run among them) is timed
   again on its own inputs to give the kernels' device time per run;
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
   more (the ten largest device ops), the kernel on layer 0's inputs
   against its plain version and the library's attention on the same
   inputs, the last-token logits of a 4,096-token prefill against a
   prefill on the plain version and against prefills with planted
   faults, decode against forward on bf16 and int8 caches,
   ``greedy_generate``;
10. StableLM-3B's prefill at full width (32 heads of 80, 2.8 B parameters
   from seed 0): a timed 32,768-token prefill (one launch a layer of the
   tensor-core kernel at hd=80), its profile, the kernel on layer 0's
   inputs as in phase 9, and the last-token logits of a 4,096-token
   prefill against the plain version's and the planted faults'.
11. the sharded index (``repro_torch.index``), each step fatal: phase 7's
   FASTA built by ``launch.build_index`` into 4 partitions with
   ``--verify`` (the minimizer kernel once a tile and no other kernel),
   and with ``--wf-backend torch`` (no kernel; every file's crc32 equal);
   ``map_fastq --index-dir`` on phase 7's FASTQ on the compacted and
   fused engines (each engine's kernels, the minimizer scan once a chunk;
   the SAM equal to phase 7's apart from ``@PG``); the arena's write
   order: the FASTA in 64 partitions, 256 reads mapped a read a chunk
   (each chunk touches a strict subset of the partitions) under a budget
   of half the index with prefetch, every result field equal to the
   whole index's, at least one eviction; a 4 Mb slice built at an origin
   of 2^31 - 2,000,000, its 4,096 reads mapped at positions straddling
   2^31, equal to the origin-0 build's shifted.  Phase 7's files are
   kept for it and removed after.
12. serving, resilience and observability, on phase 4's index (run after
   phase 10, before phase 11 frees the index), each check fatal: a
   ``MappingService`` (buckets of 64 to 16,384 reads) on the compacted and
   the fused engine fed phase 4's 131,072 reads as requests of 1 to 4,096
   reads (log-uniform from a seed) and 64 ``submit_paired`` requests of
   256 of phase 7b's pairs, every request equal to its rows of a plain
   ``Mapper.map`` / ``map_pairs``, at most 9 plan-cache misses, the four
   kernels launched, the ladder at rung 0 (requests/s, reads/s, bucket
   execute p50 and p99); a ``ResilientMapper`` on 16,384 reads with
   poisoned rows, a 5% transient bucket fault rate and ``engines=fused``,
   then ``engines=fused;cuda``: the quarantined rows and counters the
   bisection gives from the spec alone, one step down the ladder, healthy
   rows equal to a clean run; with the backend marked failing every row
   quarantined, no rung off the ``cuda`` backend and no kernel launched
   (the plain versions never stand in on the card); a fetch stall past the watchdog (``FetchStallError``
   within the watchdog + 5 s, the next run on the session clean);
   ``map_fastq --no-stream --trace-out --metrics-out --log-json`` on
   phase 7's files (phase 7's SAM, a valid trace and snapshots, the
   closing counts the registry's; the wall time split by stage); the
   device memory allocated after each of a 1-, 4- and 16-chunk run equal
   to that before it, and the peak over 16 chunks no more than over 4
   plus one chunk's; printed only: an armed-but-idle ``ResilientMapper`` and
   armed metrics and tracing against a plain ``Mapper.map``.
14. LM families (run after phase 10), three models at full width, each
   drawn on the card from seed 0 in bf16 (``init_params(cast=True)``) and
   freed before the next, the device memory held before each logged:
   Moonlight-16B-A3B (moe: 48 layers, 16/16 heads of 128, 64 experts
   top-6), Zamba2-2.7B (hybrid: 54 Mamba-2 layers, one shared attention
   block of 32 heads of 80 at 9 sites) and Falcon-Mamba-7B (ssm: 64
   Mamba-1 layers, no attention).  Each: a 32,768-token prefill through
   ``transformer.forward`` (its aux loss, finite; the MoE's (token,
   expert) pairs dropped past capacity, counted), the same prefill timed
   (the tensor-core flash kernel once an attention layer: 48, 9 and 0
   launches; Falcon-Mamba-7B's at 8,192 tokens) and, Moonlight's,
   profiled, the last-token logits of a 4,096-token prefill
   against the plain version's (and, but for the hybrid, against the
   planted faults'), decode against forward over 16 tokens (the MoE's
   forward at the decode's capacity), ``greedy_generate`` at batch 8.
   Moonlight's layer-0 q, k, v (hd=128) against the kernel's plain version
   and the planted faults, timed beside ``scaled_dot_product_attention``;
   Zamba2's first site against the plain version, timed (x 9 sites: the
   kernel's share of the prefill).  Then the lowTh=3 split
   of phase 4's index and the paper's cost model (``core.costmodel``) on
   it.
15. LM training (run after phase 14): SmolLM-135M at full width through
   the ``Trainer`` (float32 master weights from seed 0 on the card,
   adamw, remat on), train_4k's sequence of 4,096 with 32 rows in 4
   microbatches of 8, a warm-up step and 4 timed ones, under
   deterministic algorithms.  Checks: every step's loss and grad norm
   finite; no flash launch in a train step (its attention is
   ``_sdpa_chunked``'s gradient route) and 30 in each eval step (the
   tensor-core kernel); step 0's train loss against the eval step's on
   the same weights and batch within ``TRAIN_EVAL_TOL``, and the eval
   with a kv tile skipped beyond it; the eval loss on step 0's batch
   lower after the steps; a new ``Trainer`` restored from the checkpoint
   after step 3 replays step 4 to the unbroken run's state bit for
   bit; one ``reduced()`` step on the card against the same step on the
   CPU.  Prints training tokens/s, peak device memory and, from a
   ``torch.profiler`` trace of one step of one microbatch, its device
   split (the chunked attention's forward runs and backward, the
   optimizer, the other GEMMs, the elementwise chain).
16. the production mesh (run after phase 15): the H100 roofline
   (``launch.roofline``, one card) of every prefill and train step timed
   above; on a one-rank NCCL group's 1x1 ("data", "model") DTensor mesh,
   SmolLM-135M's sharded train step (parameters and adamw state placed by
   ``param_specs``) against the plain step (loss and grad norm), and a
   sharded prefill at S=4,096 whose flash calls run through
   ``local_map`` (30 launches counted, logits against the plain
   prefill's); Zamba2-2.7B's long_500k decode at full width and depth on
   a 524,288-position cache filled from a seed: 8 tokens on 8 logical
   sequence shards and unsharded (each site's attention output held
   against the unsharded one on the same inputs, the logits printed
   against the reference's bar), a shard left out of the combine (must
   fail), and the group form on the one-rank group (equal to one shard
   bit for bit); tokens/s against the bound, peak memory.

Each phase prints its seconds.  The last lines are the kernels JSON line
(phases 8, 9, 10, 14, 15 and 16, with each kernel's bound computed from its
inputs; the mapper kernels' rows also hold their launches in phase 11's
and phase 12's steps; the affine_wf_dist row also holds phase 7b's rescue, the flash
row the timed cases of phase 9, the
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
# the compacted engine's first chunk: 16,384 reads x 2 strands x 32
# candidates, the linear kernel's main-path batch
R_LINEAR_CHUNK = 1_048_576
R_MINI = 65_536
# the minimizer scan's main-path batch (one chunk of 16,384 reads on both
# strands) and phase 6's: every read of phase 4 on both strands
MINI_CHUNK, MINI_BIG = 32_768, 262_144
# phase 3 holds each WF kernel to its plain version at every compiled eth
# on PARITY_R pairs of each read length
PARITY_R, PARITY_NS = 1000, (37, N)
# and the linear and traceback kernels on short reads at every eth,
# PARITY_EDGE_R pairs (odd: a multiple of no block or pair of instances);
# the traceback also on PARITY_SMALL_R pairs, fewer than a block holds
PARITY_EDGE_R = 333
PARITY_SMALL_R = 20
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
# The linear kernel's bound is on other lanes: it holds two instances in
# the 16-bit halves of a register and runs Hopper's DPX instructions,
# which fuse an add into a min (VIADDMNMX) or take three inputs (VIMNMX3),
# and clamps only its outputs.  A pair of cells then takes four
# instructions: the mismatch xor, diag+sub as one add-min (min(xor + B,
# B + 1)), the three-input min of diag, up+1 and left+1, and B + 1 (the
# next row's up+1 and this row's next left+1).  The add can run on the
# FMA pipe (IMAD); the other three are integer-pipe instructions at the
# int32 rate (NVIDIA publishes no DPX rate; on an H100 the kernel with
# its add-min split into an IMAD and a min took the same time), so the
# least time is 1.5 integer-pipe instructions a cell at INT32_OPS_PER_S.
# LIN_OPS_PER_CELL over the same rate, the int32 bound, is logged beside.
LIN_PIPE_PER_CELL = 1.5
AFF_OPS_PER_CELL = 14
DIR_OPS_PER_CELL = 8
WALK_OPS_PER_STEP = 16
MINI_OPS_PER_KMER = 3 + 8
MINI_OPS_PER_WINDOW = 3 * 3

GENOME_BASES = 64_000_000
N_READS = 131_072
CHUNK = 16_384
# phase 7 writes chr1 with a run of N over these bases
N_RUN = (1_000_000, 1_000_200)
# phase 11, the sharded index: phase 7's FASTA in 4 partitions; the same in
# 64 partitions mapped a read a chunk under half its size with prefetch
# (each chunk touches a strict subset of the partitions); a slice built at
# an origin straddling 2^31
SHARD_PARTS = 4
EVICT_PARTS, EVICT_READS = 64, 256
ORIGIN, ORIGIN_BASES, ORIGIN_READS = 2**31 - 2_000_000, 4_000_000, 4_096
PLAIN_CHECK_READS = 2_048
ACCURACY_BAR = 0.95
# phase 7b: FR pairs of 150-base mates (the read count of phase 4), 2% of
# R2 mates replaced by random sequence; the reference's proper-pair bar
N_PAIRS = 65_536
PAIR_SEED = 2
INSERT_MEAN, INSERT_SD = 350, 30
JUNK_FRAC = 0.02
PAIR_ACCURACY_BAR = 0.97
N_KILL = 256
PAIR_FIELDS = ("proper", "mapq1", "mapq2", "rescued1", "rescued2", "insert")
# phase 12, serving, resilience and observability: a MappingService over
# phase 4's index with buckets of 64 to CHUNK reads, fed phase 4's reads
# as requests of 1 to 4,096 reads (log-uniform) and 64 paired requests of
# 256 of phase 7b's pairs, flushed a burst of 2 x CHUNK reads at a time;
# a ResilientMapper on CHUNK reads with poisoned rows and a transient
# bucket fault rate; a fetch stall past the watchdog; the trace, metrics
# and JSON log of map_fastq; device memory over 4 and 16 chunks
SVC_BUCKET_MIN, SVC_MAX_REQUEST = 64, 4_096
SVC_PAIRED, SVC_PAIRS = 64, 256
SVC_BURST = 2 * CHUNK
SVC_SEED = 12
# poisoned rows where no three block failures run in a row once the
# failing engine is left (RetryPolicy.degrade_after=3), so the injected
# engine alone steps the ladder
RESILIENT_SPEC = "poison=1000;12000,bucket=0.05,seed=7"
WATCHDOG_S, STALL_S = 2.0, 20.0
MEM_CHUNK = CHUNK // 2
# phase 13, the mesh topology: phase 4's reads on MESH_SHARDS logical
# shards of the card (the reference's mesh on 8 virtual devices); its
# overflow checks at send_cap MESH_SEND_CAP and survivor fraction
# MESH_FRAC, its service on the first MESH_REQUESTS of phase 12's requests
MESH_SHARDS = 8
MESH_SEND_CAP, MESH_FRAC = 2, 0.001
MESH_REQUESTS = 64
MESH_OVERFLOW_BAR = 0.9
OVERHEAD_ROUNDS = 5
FIELDS = ("position", "distance", "distance2", "mapped", "strand", "ops",
          "op_count", "n_candidates")
# kernels each engine launches, and those it must not
ENGINE_KERNELS = {
    "compacted": ("linear_wf", "affine_wf_dist", "affine_traceback",
                  "minimizer_scan"),
    "fused": ("linear_wf", "affine_wf_dist", "affine_traceback",
              "minimizer_scan"),
    "padded": ("linear_wf", "affine_wf", "minimizer_scan"),
}
WF_KERNELS = ("linear_wf", "affine_wf_dist", "affine_wf", "affine_traceback")
MAPPER_KERNELS = WF_KERNELS + ("minimizer_scan",)

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
# a round whose calls take longer than this (the plain versions) is not
# repeated: a stall of the host is a small share of it
LONG_CALL_MS = 100.0
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
# LM families (phase 14), each at full width: Moonlight-16B-A3B (moe,
# 16/16 heads of 128: the tensor-core kernel's hd=128 instance on a
# full-width path), Zamba2-2.7B (hybrid: 54 Mamba-2 layers and one shared
# attention block of 32 heads of 80 at 9 sites), Falcon-Mamba-7B (ssm: 64
# Mamba-1 layers, no attention)
MOE_ARCH, HYBRID_ARCH, SSM_ARCH = ("moonshot-v1-16b-a3b", "zamba2-2.7b",
                                   "falcon-mamba-7b")
# Falcon-Mamba-7B's prefill at a quarter of it: its plain chunked scan
# (jax.lax.associative_scan's combine tree over (chunk, d_inner, state) f32
# tensors, strided halves at every level) took 20.96 s at 32,768 tokens,
# three prefills a minute of the script's time (PERF.md §4)
FAMILY_SEQ = {MOE_ARCH: LM_SEQ, HYBRID_ARCH: LM_SEQ, SSM_ARCH: LM_SEQ // 4}
# the logits against the plain version's prefill (as phase 10's)
FAMILY_CHECK_SEQ = STABLELM_CHECK_SEQ
# decode against forward over this prefix, as a share of the largest
# |logit| (the MoE's forward at the decode's capacity, so that neither
# drops a token): the reference's tolerance for the SSM families
# (tests/test_models_smoke.py), and the int8 cache's.  The MoE's experts
# take one-row products in decode and cap-row ones in forward, which
# round apart by a bf16 step here and there (on the CPU, reduced: up to
# 0.94% over seeds 3-9, where the dense families read 0)
FAMILY_DEC_SEQ = 16
FAMILY_DECODE_TOL = 0.05
FAMILY_GEN_BATCH, FAMILY_GEN_PROMPT, FAMILY_GEN_NEW = 8, 16, 16
# the paper's lowTh (Sec. V-A)
LOW_TH = 3
# phase 15, LM training: SmolLM-135M at full width (remat on, as its config
# has it) at train_4k's sequence; train_4k's global batch of 256 cut to 32
# rows in 4 microbatches of 8 for the script's time (the (8, 4,096, 49,152)
# float32 logits of a microbatch are 6.4 GB); a warm-up step, then
# TRAIN_TIMED steps; adamw as the train launcher sets it up
TRAIN_ARCH = LM_ARCH
TRAIN_SEQ = 4096
TRAIN_BATCH, TRAIN_MICRO = 32, 4
TRAIN_TIMED = 4
TRAIN_LR = 3e-4
# the Trainer checkpoints after step 3 (four steps done); a new Trainer
# restored from it replays step 4 (one replayed step shows the restored
# step counter, batch and schedule; a second took 15 s of the script)
TRAIN_CKPT_EVERY = 4
# |train-step loss - eval-step loss| on step 0's batch and the initial
# weights: the train step's attention is _sdpa_chunked's gradient route
# (bf16 Q.K^T), the eval step's the tensor-core kernel (f32 scores).  The
# loss is a mean over 131,072 tokens with random labels, and random
# weights attend almost evenly over the keys, so both a rounding apart and
# a planted fault move it little: the sound reading was 1.907e-05 and the
# kernel with a kv tile skipped (each row past the first tile loses its
# diagonal tile) 5.317e-05 on an H100 (PERF.md §6); both repeat, the
# weights, batch and kernels being deterministic
TRAIN_EVAL_TOL = 3e-5
# one reduced() train step on the card against the same step through the
# port on the CPU, at S past ATTN_CHUNK_THRESHOLD (the gradient route):
# the loss and the grad norm, relative, and the largest leaf's ||card -
# CPU|| / ||CPU|| of the gradient.  Each lies between its sound reading
# (loss 1.1e-05, grad norm 4.2e-04, leaf 0.014 on an H100, PERF.md §6:
# the card's bf16 products round apart from the CPU's) and the planted
# faults' (labels shifted by one: loss 3.9e-03, grad norm 0.39, leaf 2.3;
# layer 0's gradient zeroed: grad norm 0.074, leaf 0.97), 7 to 19 times
# each side (every weight moved by a bf16 step reads, on the CPU, loss
# 2.1e-04, grad norm 4.0e-03, leaf 0.051)
TRAIN_CPU_SEQ = 3072
TRAIN_CPU_TOL = {"loss": 2e-4, "grad_norm": 4e-3, "leaf": 0.1}
# phase 16, the production mesh: Zamba2-2.7B's long_500k decode (batch
# 1; its 9 shared-attention sites' KV cache at 524,288 positions, 48.3 GB
# in bf16) over MESH_DEC_STEPS tokens at the cache's last positions, on
# LONG_SHARDS logical sequence shards (the local form) and unsharded.  The
# cache and the SSM states are filled in place from a seed on the card (a
# 524,288-token prefill would take minutes); keys of std 2 make each
# query's softmax peak on a few positions spread over the shards, so that
# a shard left out of the combine moves the logits
LONG_SEQ, LONG_SHARDS, MESH_DEC_STEPS = 524_288, 8, 8
LONG_K_STD, LONG_V_STD, LONG_STATE_STD = 2.0, 1.0, 0.1
# max |logit diff|, the reference's long-context bar (its
# tests/test_distributed.py, sharded against unsharded decode on a
# reduced config, which tests/test_torch_mesh.py holds), printed here: at
# full width and depth the random model carries a one-ulp change of one
# attention output to about 3% of the logits (the 8-shard and the 1-shard
# flash-decode, the same arithmetic but for how 8 bf16 partial sums are
# added, read 0.125-0.16 apart on the CPU at S=8,192; 0.1797 against the
# unsharded decode on the card, PERF.md §6), so no logits bar separates a
# sound combine from a faulty one.  The check is made where phase 14 made
# it for this model's flash kernel: at every site of every step, the
# sharded attention output against the unsharded one on the same q and
# cache, within LONG_ATTN_TOL of the latter's largest |element| (bf16
# partial sums: a few 2^-9 steps; a shard left out moves it by a share of
# the mass)
LONG_DECODE_TOL = 0.05
LONG_ATTN_TOL = 2.0 ** -6
# the sharded train step on a 1x1 DTensor mesh (a one-rank NCCL group):
# SmolLM-135M at full width, 8 rows of 512; its loss and grad norm against
# the plain step's, relative (on one rank the same products run: the
# reading was 0 on the CPU); and a prefill at S=4,096 whose flash calls go
# through local_map on head-sharded DTensors
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 8, 512
MESH_TRAIN_TOL = 1e-5
MESH_PREFILL_SEQ = 4096


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


def edge_batch(rng, R, n, eth):
    """``pair_batch``'s pairs in every byte the wrappers take: a quarter
    of the near-match pairs mapped through a random table of bytes 0..255
    per row, a quarter of the random pairs drawn from 0..255, then a
    tenth of all bytes set to SENTINEL (4)."""
    from repro_torch.core.encoding import SENTINEL
    s1, s2 = pair_batch(rng, R, n, eth)
    q = R // 4
    lut = rng.integers(0, 256, (q, 4)).astype(np.uint8)
    s1[:q] = np.take_along_axis(lut, s1[:q], axis=1)
    s2[:q] = np.take_along_axis(lut, s2[:q], axis=1)
    s1[R - q:] = rng.integers(0, 256, (q, n))
    s2[R - q:] = rng.integers(0, 256, (q, n + 2 * eth))
    for s in (s1, s2):
        s[rng.random(s.shape) < 0.1] = SENTINEL
    return s1, s2


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """ms per call of ``fn``: CUDA events around ``reps`` calls after
    ``warmup``, the least mean of TIMING_ROUNDS such rounds (one where a
    call takes more than LONG_CALL_MS)."""
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
        if best > LONG_CALL_MS:
            break
    return best


def device_ms(fn, word, calls=20):
    """Device time (ms) a call of ``fn`` spends in the kernels whose names
    hold ``word``: ``torch.profiler`` over ``calls`` calls after one,
    which leaves out the host's time between launches that CUDA events
    around a row of short calls take in; None when the trace holds no
    such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and word in e.key)
    return us / calls / 1e3 if us else None


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


def phase_sass():
    """The loops of the linear and traceback kernels' SASS at eth=ETH and
    of the minimizer kernel's k-mer codes route, instructions by opcode
    (``cuobjdump -sass`` on the built libraries), for work on those
    kernels; not part of the full run."""
    from repro_torch.kernels import build
    info = build.build()
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        log(f"sass: no {tool}, loops not counted")
        return
    for lib, kernel in (("linear_wf", f"linear_wf_kernelILi{ETH}E"),
                        ("traceback", f"affine_traceback_kernelILi{ETH}E"),
                        ("minimizer", "minimizer_kernelILb1E")):
        sass = subprocess.run([tool, "-sass", info[lib]["path"]],
                              capture_output=True, text=True,
                              check=True).stdout
        for lo, hi, ops in sass_loops(sass, kernel):
            top = ", ".join(f"{op} {c}" for op, c in
                            sorted(ops.items(), key=lambda x: -x[1]))
            log(f"sass {kernel}: loop {lo:#06x}-{hi:#06x}: "
                f"{sum(ops.values())} instructions: {top}")


def sass_loops(sass, kernel):
    """The loops of the function whose name holds ``kernel`` in
    ``cuobjdump -sass`` output: [(first address, branch address, {opcode:
    count})] for every backward branch over 8 or more instructions."""
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next((f for f in funcs[1:] if kernel in f.split("\n", 1)[0]), "")
    label_at, pending, insts = {}, [], []
    for line in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_]*)\S*(.*)", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        label_at.update((lab, addr) for lab in pending)
        pending = []
        insts.append((addr, m.group(2), m.group(3)))
    loops = []
    for addr, op, rest in insts:
        t = re.search(r"(\.L_x_\d+)|(0x[0-9a-f]+)", rest) \
            if op == "BRA" else None
        if t is None:
            continue
        to = label_at.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
        if to is None or to > addr:
            continue
        ops = {}
        for a, o, _ in insts:
            if to <= a <= addr:
                ops[o] = ops.get(o, 0) + 1
        if sum(ops.values()) >= 8:
            loops.append((to, addr, ops))
    return sorted(loops)


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
    """Each WF kernel's wrapper, plain version, provenance, the engine
    whose run gives its main-path row and, where phase 3 times it there
    too, its main-path batch (``chunk``); every callable takes (s1,
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
            engine="compacted", chunk=R_LINEAR_CHUNK),
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
            engine="compacted", chunk=CHUNK),
    }


def bound(name, R, n, eth, max_ops, steps=0):
    """(bound_ms, bound_by): the larger of the recurrence's int32
    operations (the linear kernel's: its integer-pipe instructions) over
    the int32 rate and the bytes read and written once over the HBM rate.
    ``steps``: the traceback's walk lengths summed."""
    cells = R * n * (2 * eth + 1)
    n_bytes = R * (2 * n + 2 * eth + 8)
    if name == "linear_wf":
        n_ops = LIN_PIPE_PER_CELL * cells
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


def lin_int32_ms(R, n, eth):
    """The linear recurrence's 7 int32 operations a cell over the int32
    rate: its bound on int32 lanes, one instance a thread."""
    return LIN_OPS_PER_CELL * R * n * (2 * eth + 1) / INT32_OPS_PER_S * 1e3


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


def _minimizer_plain(seqs, k, w, codes=False):
    """The minimizer kernel's plain version: ``minimizers``' (hashes,
    positions), or with ``codes`` its (k-mer codes, positions)."""
    from repro_torch.core.minimizers import minimizers
    h, c, p = minimizers(seqs, k=k, w=w)
    return (c if codes else h), p


def _mini_rows(rng, R, L, top=4):
    """R rows of L random bytes below ``top``; with ``top`` > 4 a tenth
    of the bytes are SENTINEL (4) as well."""
    from repro_torch.core.encoding import SENTINEL
    s = rng.integers(0, top, (R, L)).astype(np.uint8)
    if top > 4:
        s[rng.random(s.shape) < 0.1] = SENTINEL
    return s


def _mini_parity_cases():
    """(R, L, k, w, top) of phase 3's minimizer parity: ragged R, the
    main path's geometry, every byte (SENTINEL, 0..255), k=16 (the codes
    fill 32 bits and wrap), w=1, a row of exactly one window, fewer rows
    than a block holds, and the index build's rows (``_SCAN_ROW``
    windows)."""
    from repro_torch.core.index import _SCAN_ROW
    return [(1000, 80, 8, 16, 4), (R_MINI, N, K, W, 4),
            (PARITY_EDGE_R, N, K, W, 256), (PARITY_EDGE_R, N, 16, W, 256),
            (PARITY_EDGE_R, N, 16, 7, 4), (PARITY_EDGE_R, N, K, 1, 256),
            (PARITY_EDGE_R, W + K - 1, K, W, 256),
            (PARITY_EDGE_R, W + 15, 16, W, 4),
            (PARITY_SMALL_R, N, K, W, 256), (PARITY_SMALL_R, N, K, W, 4),
            (1, N, K, W, 4), (64, _SCAN_ROW + W + K - 2, K, W, 4),
            (7, _SCAN_ROW + W + K - 2, K, W, 256)]


def phase_minimizer_parity():
    """The minimizer scan against its plain version, both routes of its
    first output (hashes; k-mer codes), on ``_mini_parity_cases``; then
    timed on random reads at seeding's chunk (MINI_CHUNK rows, k-mer
    codes: the main path's route) and at MINI_BIG rows (both routes)."""
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(12)
    for R, L, k, w, top in _mini_parity_cases():
        seqs = torch.from_numpy(_mini_rows(rng, R, L, top)).cuda()
        for codes in (False, True):
            got = ops.minimizer_scan(seqs, k=k, w=w, codes=codes)
            torch.cuda.synchronize()
            _compare(f"minimizer_scan R={R} L={L} k={k} w={w} bytes<{top} "
                     f"codes={codes}", got,
                     _minimizer_plain(seqs, k, w, codes))
    log(f"parity minimizer_scan: {len(_mini_parity_cases())} cases (R, L, "
        f"k, w, bytes below): {_mini_parity_cases()}, hashes and k-mer "
        f"codes: bit-identical (tolerance 0: integer outputs)")
    big = torch.from_numpy(_mini_rows(rng, MINI_BIG, N)).cuda()
    for R, codes in ((MINI_CHUNK, True), (MINI_BIG, True), (MINI_BIG, False)):
        seqs = big[:R]
        ms = cuda_ms(lambda: ops.minimizer_scan(seqs, k=K, w=W, codes=codes),
                     50, 3)
        plain_ms = cuda_ms(lambda: _minimizer_plain(seqs, K, W, codes), 2, 1)
        outs = ops.minimizer_scan(seqs, k=K, w=W, codes=codes)
        fill_ms = cuda_ms(lambda: [t.fill_(0) for t in outs], 50, 3)
        b_ms, b_by = minimizer_bound(R, N, K, W)
        log(f"timing minimizer_scan (random reads, codes={codes}): R={R}: "
            f"{ms:.4f} ms/call, plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), {b_ms / ms:.1%} of bound; a fill_ of its two "
            f"outputs (the same bytes written) {fill_ms:.4f} ms")


def _edge_ns(eth):
    """Read lengths no longer than the band and just past it: every
    row's band reaching left of column 0, all but the last's, and rows
    past them."""
    return sorted({1, eth, eth + 1, 2 * eth + 1} - {0})


def _parity_cases(name, k, eths):
    """Phase 3's (R, n, eth, max_ops values) for one kernel: ragged R
    (off every block size), short and main-path reads, every band; the
    main path's geometry last."""
    mos = (lambda n: (1, 3, 2 * n + 2)) if name == "affine_traceback" \
        else (lambda n: (2 * n + 2,))
    cases = [(PARITY_R, n, eth, mos(n)) for eth in eths for n in PARITY_NS]
    if name in ("linear_wf", "affine_traceback"):
        cases += [(PARITY_EDGE_R, n, eth, mos(n)) for eth in eths
                  for n in _edge_ns(eth)]
    if name == "affine_traceback":
        cases += [(PARITY_SMALL_R, 2 * eth + 1, eth, mos(2 * eth + 1))
                  for eth in eths]
        cases.append((PARITY_R, 37, 4, (40,)))
    cases.append((k["R"], N, ETH, (MAX_OPS,)))
    return cases


def _plain_at(name, k, a, b, eth):
    """The plain version of kernel ``name`` on (a, b) as a function of
    max_ops; the traceback's forward pass runs once for all of them."""
    if name != "affine_traceback":
        return lambda mo: k["plain"](a, b, eth, mo)
    from repro_torch.core.affine_wf import banded_affine, traceback
    de, dm, dirs = banded_affine(a, b, eth=eth, sat=SAT)
    return lambda mo: (de, dm, *traceback(dirs, eth, mo))


def phase_parity(names=None):
    """Each WF kernel (those in ``names``, by default all) against its
    plain version on generated pairs: at every compiled eth
    (``ops.SUPPORTED_ETH``) on PARITY_R pairs of each of PARITY_NS read
    lengths, then on the main path's geometry (timed).  The linear and
    traceback kernels take ``edge_batch``'s bytes, also on PARITY_EDGE_R
    reads of 1, eth, eth+1 and 2*eth+1 bases at every eth, and are timed
    at their main-path batch (``chunk``) too; the traceback at max_ops
    1, 3 and 2n+2 in each case, and on PARITY_SMALL_R reads of 2*eth+1
    bases."""
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(11)
    dev = torch.device("cuda")
    eths = ops.SUPPORTED_ETH
    for name, k in _kernels().items():
        if names is not None and name not in names:
            continue
        gen = edge_batch if name in ("linear_wf", "affine_traceback") \
            else pair_batch
        for R, n, eth, mos in _parity_cases(name, k, eths):
            s1, s2 = gen(rng, R, n, eth)
            a, b = torch.from_numpy(s1).to(dev), torch.from_numpy(s2).to(dev)
            plain = _plain_at(name, k, a, b, eth)
            for mo in mos:
                got = k["run"](a, b, eth, mo)
                torch.cuda.synchronize()
                _compare(f"{name} R={R} n={n} eth={eth} max_ops={mo}", got,
                         plain(mo))
        what = ""
        if name == "linear_wf":
            what = (f"; bytes 0..255 and SENTINEL; R={PARITY_EDGE_R}, n in "
                    f"(1, eth, eth+1, 2eth+1) at every eth")
        if name == "affine_traceback":
            what = (f", 1 and 3 (and 40 at n=37, eth=4); bytes 0..255 and "
                    f"SENTINEL; R={PARITY_EDGE_R}, n in (1, eth, eth+1, "
                    f"2eth+1) and R={PARITY_SMALL_R}, n=2eth+1 at every eth, "
                    f"max_ops 1, 3 and 2n+2")
        log(f"parity {name}: R={PARITY_R}, n in {PARITY_NS}, every eth in "
            f"{eths[0]}..{eths[-1]}, max_ops 2n+2{what}; R={k['R']}, "
            f"n={N}, eth={ETH}: bit-identical (tolerance 0: "
            f"integer outputs)")
        timed = [(k["R"], a, b)]
        if "chunk" in k:
            # the main-path batch's size: the generated pairs repeated
            a, b = (t.repeat(k["chunk"] // k["R"], 1) for t in (a, b))
            _compare(f"{name} R={k['chunk']}",
                     k["run"](a, b, ETH, MAX_OPS),
                     k["plain"](a, b, ETH, MAX_OPS))
            timed.append((k["chunk"], a, b))
        for R, a, b in timed:
            ms = cuda_ms(lambda: k["run"](a, b, ETH, MAX_OPS), k["reps"], 3)
            plain_ms = cuda_ms(lambda: k["plain"](a, b, ETH, MAX_OPS), 2, 1)
            steps = int(k["run"](a, b, ETH, MAX_OPS)[3].sum()) \
                if name == "affine_traceback" else 0
            b_ms, b_by = bound(name, R, N, ETH, MAX_OPS, steps)
            i32 = ""
            if name == "linear_wf":
                i32_ms = lin_int32_ms(R, N, ETH)
                i32 = (f"; int32 bound {i32_ms:.4f} ms, "
                       f"{i32_ms / ms:.1%}")
            log(f"timing {name} (generated pairs): R={R}: {ms:.4f} ms/call "
                f"({R / ms * 1e3:,.0f} instances/s), plain {plain_ms:.2f} "
                f"ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of "
                f"bound{i32}")
        if name == "affine_wf":
            log(f"timing affine_wf: a contiguous (R, n, band) copy of the "
                f"direction planes, which the wrapper does not make: "
                f"{cuda_ms(lambda: got[2].contiguous(), 20, 2):.4f} ms")


class KernelInputs:
    """Keeps a copy of the inputs of every kernel launch made inside it, by
    wrapping the mapper's wrappers of ``repro_torch.kernels.ops`` that
    ``core.wf_backend`` calls (the four WF kernels' and
    ``minimizer_scan``); the wrappers and their launch counters are
    unchanged."""

    def __init__(self):
        self.calls = {name: [] for name in MAPPER_KERNELS}

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
        if name == "minimizer_scan":
            def scan(seqs, **kw):
                if (kw.get("k"), kw.get("w"), kw.get("codes")) != (K, W,
                                                                  True):
                    raise AssertionError(f"minimizer_scan called with {kw}, "
                                         f"not the main path's k={K}, "
                                         f"w={W}, codes=True")
                if seqs.is_cuda:
                    self.calls[name].append(seqs.clone())
                return fn(seqs, **kw)
            return scan

        def wrapped(s1, s2_window, **kw):
            if kw.get("eth") != ETH or kw.get("sat", SAT) != SAT:
                raise AssertionError(f"{name} called with {kw}, not the "
                                     f"main path's eth={ETH}, sat={SAT}")
            if s1.is_cuda:
                self.calls[name].append((s1.clone(), s2_window.clone(),
                                         kw.get("max_ops", MAX_OPS)))
            return fn(s1, s2_window, **kw)
        return wrapped


def _check_launches(what, engine, launches, minimizer=None, also=()):
    """Each kernel of ``engine`` (and of ``also``: the mate rescue's
    ``affine_wf_dist`` on paired runs) launched, and no other mapper
    kernel; the minimizer scan ``minimizer`` times where that is given."""
    for name in MAPPER_KERNELS:
        if (launches[name] > 0) != (name in ENGINE_KERNELS[engine] + also):
            raise AssertionError(f"{what}: {engine} launched {name} "
                                 f"{launches[name]} times: {launches}")
    if minimizer is not None and launches["minimizer_scan"] != minimizer:
        raise AssertionError(f"{what}: {engine} launched minimizer_scan "
                             f"{launches['minimizer_scan']} times, not "
                             f"{minimizer}: {launches}")


def _scan_tiles(ref):
    """Tiles of the index build's minimizer scan over ``ref``: its
    launches of the kernel."""
    from repro_torch.core.index import _SCAN_TILE
    return -(-(len(ref) - (W + K - 1) + 1) // _SCAN_TILE)


def _time_index_scan(ref):
    """The index build's scan of its first tile, kernel route against
    plain route on the same tile: equal outputs; ms of each."""
    import torch
    from repro_torch.core import index
    dev = torch.device("cuda")
    w1 = min(index._SCAN_TILE, len(ref) - (W + K - 1) + 1)
    got = index._scan_tile(ref, 0, w1, K, W, dev, "cuda")
    _compare(f"index scan tile of {w1:,} windows", got,
             index._scan_tile(ref, 0, w1, K, W, dev, "torch"))
    ms = cuda_ms(lambda: index._scan_tile(ref, 0, w1, K, W, dev, "cuda"),
                 5, 1)
    plain_ms = cuda_ms(lambda: index._scan_tile(ref, 0, w1, K, W, dev,
                                                "torch"), 1, 1)
    log(f"index build scan, tile of {w1:,} windows (rows of "
        f"{index._SCAN_ROW}): kernel route {ms:.3f} ms, plain route "
        f"{plain_ms:.3f} ms, equal (both with the tile's host-to-device "
        f"copy)")
    return dict(windows=w1, ms=ms, plain_ms=plain_ms)


def phase_e2e():
    import torch
    from repro_torch.core.index import build_index
    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pipeline import MapperConfig
    from repro_torch.data.genome import make_reference, sample_reads
    from repro_torch.kernels import ops

    log(f"end to end: reference of {GENOME_BASES:,} bases — GRCh38 "
        f"(3.1 Gb) is cut to 64 Mb because the flat index build runs on "
        f"the host inside this run's time limit")
    t0 = time.perf_counter()
    ref = make_reference(GENOME_BASES, seed=0, repeat_frac=0.02)
    t1 = time.perf_counter()
    ops.reset_launch_counts()
    idx = build_index(ref)
    t2 = time.perf_counter()
    n_scan = ops.LAUNCHES["minimizer_scan"]
    log(f"reference {t1 - t0:.2f} s; build_index {t2 - t1:.2f} s: "
        f"{len(idx.uniq_kmers):,} minimizers, {len(idx.positions):,} "
        f"occurrences, segments {idx.segments.nbytes / 1e9:.3f} GB; "
        f"minimizer_scan launched {n_scan} times")
    if n_scan != _scan_tiles(ref):
        raise AssertionError(f"build_index launched minimizer_scan {n_scan} "
                             f"times, not once for each of its "
                             f"{_scan_tiles(ref)} tiles")
    scan = _time_index_scan(ref)
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
        _check_launches("Mapper.map", engine, launches,
                        minimizer=res.stats["n_chunks"])
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

    runs["compacted"]["index_scan"] = scan
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
    _check_launches("Mapper.map", "padded", launches, minimizer=1)
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


def phase_minimizer_encodings(rs):
    """``ops.minimizer_scan`` on generated input of seeding's kind: every
    read's forward and reverse-complement encodings in one call (262,144
    rows; seeding itself scans a chunk of them a launch), both routes of
    its first output held against the plain version.  -> its timings."""
    import torch
    from repro_torch.core.encoding import revcomp
    from repro_torch.kernels import ops

    seqs = torch.from_numpy(np.concatenate([rs.reads, revcomp(rs.reads)])
                            ).cuda()
    R, L = seqs.shape
    b_ms, b_by = minimizer_bound(R, L, K, W)
    out = dict(instances=int(R), bound_ms=b_ms)
    for codes in (True, False):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = ops.minimizer_scan(seqs, k=K, w=W, codes=codes)
        torch.cuda.synchronize()
        launches = ops.LAUNCHES["minimizer_scan"]
        if launches != 1:
            raise AssertionError(f"minimizer_scan launched {launches} times")
        _compare(f"minimizer_scan R={R} codes={codes}", got,
                 _minimizer_plain(seqs, K, W, codes))
        ms = cuda_ms(lambda: ops.minimizer_scan(seqs, k=K, w=W, codes=codes),
                     20, 3)
        plain_ms = cuda_ms(lambda: _minimizer_plain(seqs, K, W, codes), 1, 1)
        out["codes_ms" if codes else "hashes_ms"] = ms
        log(f"minimizer_scan on seeding's encodings, codes={codes}: "
            f"R={R:,} reads of {L}: bit-identical to the plain version; "
            f"{ms:.4f} ms/call ({R / ms * 1e3:,.0f} reads/s), plain "
            f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{b_ms / ms:.1%} of bound")
    return out


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


class BuildLaunches:
    """Inside it, ``core.index.build_index`` (which ``map_fastq`` imports
    when it runs) records the minimizer kernel's launches of each build
    and the tiles of its reference."""

    def __enter__(self):
        from repro_torch.core import index
        from repro_torch.kernels import ops
        self.builds, self._saved = [], index.build_index

        def build_index(ref, *a, **kw):
            before = ops.LAUNCHES["minimizer_scan"]
            idx = self._saved(ref, *a, **kw)
            self.builds.append((ops.LAUNCHES["minimizer_scan"] - before,
                                _scan_tiles(ref)))
            return idx
        index.build_index = build_index
        return self

    def __exit__(self, *exc):
        from repro_torch.core import index
        index.build_index = self._saved


def _map_fastq_run(args, what, kernels=True):
    """``map_fastq.main(args)`` in-process -> (wall s, its stderr, the
    launches during it, minimizer launches of its index build), checking
    that the build launched the minimizer kernel once a tile (with
    ``kernels``) or never."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import map_fastq
    err = io.StringIO()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err), BuildLaunches() as built:
        rc = map_fastq.main(args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"map_fastq {what}: exit {rc}\n{err.getvalue()}")
    (n_build, tiles), = built.builds
    if n_build != (tiles if kernels else 0):
        raise AssertionError(f"map_fastq {what}: its index build launched "
                             f"minimizer_scan {n_build} times for {tiles} "
                             f"tiles")
    return dt, err.getvalue(), dict(ops.LAUNCHES), n_build


def phase_map_fastq(ref, rs, work):
    """``map_fastq`` in-process on each engine, from FASTA and FASTQ files
    written by the port's writers into ``work``, and on the compacted
    engine with ``--wf-backend torch`` (the all-plain route).  -> the
    FASTA, the FASTQ and the compacted SAM's lines apart from ``@PG``,
    for phase 11."""
    from repro_torch.data.genome import write_fasta, write_fastq
    from repro_torch.io.sam import validate_sam

    half = GENOME_BASES // 2
    chr1 = ref[:half].copy()
    chr1[N_RUN[0]:N_RUN[1]] = 4            # a run of N
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
    chunks = -(-N_READS // CHUNK)
    for engine in ("compacted", "fused", "padded"):
        out = os.path.join(work, f"{engine}.sam")
        dt, err, launches[engine], n_build = _map_fastq_run(
            [fa, fq, "-o", out, "--engine", engine, "--chunk-reads",
             str(CHUNK)], f"--engine {engine}")
        _check_launches("map_fastq", engine, launches[engine],
                        minimizer=n_build + chunks)
        done = [ln for ln in err.splitlines()
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
            f"{launches[engine]}, minimizer_scan {n_build} of them in "
            f"the index build")
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
    # the plain route on the first chunk's reads (each read's record
    # depends on that read alone), against the kernel route's header
    # and first CHUNK records
    fq1, out = (os.path.join(work, f) for f in ("chunk.fq", "plain.sam"))
    write_fastq(fq1, rs.reads[:CHUNK], rs.quals[:CHUNK],
                [f"read{i}" for i in range(CHUNK)])
    dt, _, plain, _ = _map_fastq_run(
        [fa, fq1, "-o", out, "--wf-backend", "torch", "--chunk-reads",
         str(CHUNK)], "--wf-backend torch", kernels=False)
    if any(plain[name] for name in MAPPER_KERNELS):
        raise AssertionError(f"map_fastq --wf-backend torch launched "
                             f"kernels: {plain}")
    with open(out) as f:
        body = [ln for ln in f.read().splitlines()
                if not ln.startswith("@PG")]
    n_head = sum(ln.startswith("@") for ln in bodies["compacted"])
    if body != bodies["compacted"][: n_head + CHUNK]:
        raise AssertionError("map_fastq: the --wf-backend torch SAM "
                             "differs from the kernel route's")
    log(f"map_fastq --wf-backend torch on the first {CHUNK:,} reads (no "
        f"kernel launched, index build included): {dt:.2f} s wall; its "
        f"SAM equals the kernel route's header and first {CHUNK:,} "
        f"records apart from @PG")
    return dict(fa=fa, fq=fq, body=bodies["compacted"])


def _same_resolution(what, a, b):
    """Two ``PairResolution``s equal on every field (of the mate results,
    those both engines give) and in their stats."""
    for m in ("res1", "res2"):
        for f in FIELDS:
            x, y = getattr(getattr(a, m), f), getattr(getattr(b, m), f)
            if (x is None) != (y is None) or (x is not None and
                                              not np.array_equal(x, y)):
                raise AssertionError(f"{what}: {m}.{f} differs")
    for f in PAIR_FIELDS:
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: {f} differs")
    if a.stats != b.stats:
        raise AssertionError(f"{what}: stats differ: {a.stats} != "
                             f"{b.stats}")


def _pairs_right(pr, ps):
    """Per pair: both mates within eth of the truth on the right strand,
    and proper."""
    return ((np.abs(pr.res1.position - ps.pos1) <= ETH)
            & (np.abs(pr.res2.position - ps.pos2) <= ETH)
            & (pr.res1.strand == ps.strand1) & (pr.res2.strand == ps.strand2)
            & pr.proper)


def _sam_pair_accuracy(text, ps, keep):
    """``_pairs_right``'s share of ``keep`` read back from the SAM of a
    one-contig FASTA:
    both records of ``pair<i>`` mapped, POS within eth, the right FLAG
    0x10, and 0x2."""
    ok = np.ones(len(ps.pos1), dtype=bool)
    for ln in text.splitlines():
        if ln.startswith("@"):
            continue
        f = ln.split("\t", 4)
        i, flag = int(f[0][4:]), int(f[1])
        pos, strand = ((ps.pos2, ps.strand2) if flag & 0x80
                       else (ps.pos1, ps.strand1))
        ok[i] &= bool(not flag & 0x4 and flag & 0x2
                      and abs(int(f[3]) - 1 - int(pos[i])) <= ETH
                      and bool(flag & 0x10) == bool(strand[i]))
    return float(ok[keep].mean())


def phase_paired(idx, ref):
    """7b: paired-end at the published geometry on phase 4's reference and
    index.  ``Mapper.map_pairs`` + ``resolve_pairs`` on both engines, mate
    rescue at scale on the affine-distance kernel, and ``map_fastq``
    ``--r1 --r2`` (with the other engines, ``--interleaved`` and
    ``--wf-backend torch`` on the first chunk).  -> (the compacted paired
    path's run: wall s, launches, kept kernel inputs; the rescue's
    numbers for the affine_wf_dist row)."""
    import dataclasses

    import torch
    from repro_torch.core import pairing
    from repro_torch.core.affine_wf import banded_affine_dist
    from repro_torch.core.mapper import Mapper, split_result
    from repro_torch.core.pipeline import MapperConfig
    from repro_torch.data.genome import (sample_pairs, write_fasta,
                                         write_fastq_pair)
    from repro_torch.io.sam import validate_sam
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ps = sample_pairs(ref, N_PAIRS, read_len=N, insert_mean=INSERT_MEAN,
                      insert_sd=INSERT_SD, unmappable_frac=JUNK_FRAC,
                      seed=PAIR_SEED)
    # the junk mask as sample_pairs draws it
    junk = (np.random.default_rng(PAIR_SEED + 0x7777).random(N_PAIRS)
            < JUNK_FRAC)
    keep = ~junk
    log(f"paired: sample_pairs {N_PAIRS:,} pairs ({2 * N_PAIRS:,} reads, "
        f"insert {INSERT_MEAN} +- {INSERT_SD}) in "
        f"{time.perf_counter() - t0:.2f} s; {int(junk.sum()):,} R2 mates "
        f"replaced by random sequence")
    ref_dev = torch.from_numpy(ref).cuda()    # the rescue's genome
    reads = dict(reads1=ps.reads1, reads2=ps.reads2)
    resolved, mapped = {}, {}
    for engine in ("compacted", "fused"):
        cfg = MapperConfig.from_index(idx, both_strands=True,
                                      chunk_reads=CHUNK, engine=engine,
                                      cigar_mode="eager")
        mapper = Mapper(idx, cfg)
        mapper.map_pairs(ps.reads1[:CHUNK // 2], ps.reads2[:CHUNK // 2])
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        res1, res2 = mapper.map_pairs(ps.reads1, ps.reads2)
        t2 = time.perf_counter()
        pr = pairing.resolve_pairs(res1, res2, cfg=cfg, ref=ref_dev,
                                   device=mapper.device, **reads)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = dict(ops.LAUNCHES)
        _check_launches("map_pairs + resolve_pairs", engine, launches,
                        minimizer=res1.stats["n_chunks"])
        log(f"paired {engine}: map_pairs {t2 - t1:.3f} s + resolve_pairs "
            f"{t3 - t2:.3f} s = {N_PAIRS / (t3 - t1):,.0f} pairs/s; "
            f"launches {launches}; {pr.stats['n_proper']:,} proper, "
            f"{pr.stats['n_discordant']:,} discordant, "
            f"{pr.stats['n_rescued']} rescued, insert median "
            f"{pr.stats['insert_median']} window "
            f"{pr.stats['insert_window']}")
        resolved[engine], mapped[engine] = pr, (res1, res2, cfg, mapper)
        if engine == "compacted":
            path = dict(wall_s=t3 - t1, launches=launches)
    _same_resolution("paired: compacted and fused", resolved["compacted"],
                     resolved["fused"])
    pr = resolved["compacted"]
    right = _pairs_right(pr, ps)
    acc = float(right[keep].mean())
    log(f"paired: compacted == fused on every PairResolution field; "
        f"proper-pair accuracy over the {int(keep.sum()):,} pairs whose R2 "
        f"is real {acc:.5f}; junk mates rescued "
        f"{int(pr.rescued2[junk].sum())}")
    if acc < PAIR_ACCURACY_BAR:
        raise AssertionError(f"paired accuracy {acc} below "
                             f"{PAIR_ACCURACY_BAR}")
    if pr.rescued2[junk].any():
        raise AssertionError("paired: a junk mate was rescued")
    res1, res2, cfg, mapper = mapped["compacted"]
    with KernelInputs() as kept:           # the same run, inputs kept
        again = pairing.resolve_pairs(*mapper.map_pairs(ps.reads1,
                                                        ps.reads2),
                                      cfg=cfg, ref=ref_dev,
                                      device=mapper.device, **reads)
    _same_resolution("paired: a second run", again, pr)
    path["calls"] = kept.calls

    # rescue at scale: unmap the R2 mates of the first N_KILL pairs that
    # resolved right and whose R2 aligned within the rescue's threshold
    # (distance <= eth).  A wrong anchor (a read of a repeat placed on
    # its other copy) has no true mate window, and a mate of distance
    # past eth is refused by the rescue by design, in both packages.
    rescuable = right & (res2.distance <= ETH)
    kill = np.flatnonzero(rescuable)[:N_KILL]
    res2.mapped[kill] = False
    res2.position[kill] = -1
    ops.reset_launch_counts()
    with KernelInputs() as kept:
        t1 = time.perf_counter()
        prk = pairing.resolve_pairs(res1, res2, cfg=cfg, ref=ref_dev,
                                    device=mapper.device, **reads)
        dt = time.perf_counter() - t1
    launches = dict(ops.LAUNCHES)
    calls = kept.calls["affine_wf_dist"]
    rows = [c[0].shape[0] for c in calls]
    if not launches["affine_wf_dist"] or any(
            launches[k] for k in MAPPER_KERNELS if k != "affine_wf_dist"):
        raise AssertionError(f"rescue launched {launches}")
    if not (prk.rescued2[kill].all() and not prk.rescued2[junk].any()
            and (prk.res2.strand[kill] == ps.strand2[kill]).all()
            and (np.abs(prk.res2.position[kill] - ps.pos2[kill])
                 <= 2).all()):
        raise AssertionError("rescue: a killed mate was not rescued on its "
                             "strand within 2 bases, or junk was rescued")
    if (prk.mapq2[kill] > np.minimum(prk.mapq1[kill],
                                     pairing._RESCUE_CAP)).any():
        raise AssertionError("rescue: a rescued mate's MAPQ exceeds its "
                             "anchor's or the cap")
    err = max(_compare(f"affine_wf_dist on the rescue's {r:,} rows",
                       ops.affine_wf_dist(s1, s2, eth=ETH, sat=SAT),
                       banded_affine_dist(s1, s2, eth=ETH, sat=SAT))
              for (s1, s2, _), r in zip(calls, rows))
    s1, s2, _ = calls[int(np.argmax(rows))]
    ms = cuda_ms(lambda: ops.affine_wf_dist(s1, s2, eth=ETH, sat=SAT), 20, 3)
    plain_ms = cuda_ms(lambda: banded_affine_dist(s1, s2, eth=ETH, sat=SAT),
                       1, 1)
    b_ms, b_by = bound("affine_wf_dist", s1.shape[0], N, ETH, MAX_OPS)
    rescue = dict(rows=rows, launches=launches["affine_wf_dist"],
                  wall_s=dt, rescued=prk.stats["n_rescued"],
                  max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                  bound_by=b_by)
    log(f"rescue: {N_KILL} killed R2 mates all rescued (within 2 bases, "
        f"right strand, MAPQ capped; of the {int(right.sum()):,} pairs "
        f"resolved right, {int((right & ~rescuable).sum())} have an R2 "
        f"past the rescue's threshold), {prk.stats['n_rescued']} rescued "
        f"in all, no junk; resolve_pairs {dt:.3f} s wall; affine_wf_dist "
        f"launched {launches['affine_wf_dist']} times on {rows} rows "
        f"(pow-2 buckets), bit-identical to its plain version; "
        f"{ms:.4f} ms on the {s1.shape[0]:,} rows, plain {plain_ms:.2f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound")
    f1, f2 = (split_result(r, CHUNK)[0] for r in (res1, res2))
    first = dict(reads1=ps.reads1[:CHUNK], reads2=ps.reads2[:CHUNK])
    want = pairing.resolve_pairs(f1, f2, cfg=cfg, ref=ref_dev,
                                 device=mapper.device, **first)
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    got = pairing.resolve_pairs(
        f1, f2, cfg=dataclasses.replace(cfg, wf_backend="torch"),
        ref=ref_dev, device=mapper.device, **first)
    dt = time.perf_counter() - t1
    if any(ops.LAUNCHES[k] for k in MAPPER_KERNELS):
        raise AssertionError(f"resolve_pairs on wf_backend torch launched "
                             f"{ops.LAUNCHES}")
    _same_resolution("resolve_pairs on wf_backend torch", got, want)
    if not want.stats["n_rescued"]:
        raise AssertionError("the first chunk rescued no mate")
    log(f"resolve_pairs on the first {CHUNK:,} pairs, wf_backend torch: no "
        f"kernel launched, {dt:.3f} s, the same PairResolution as the "
        f"kernel route ({want.stats['n_rescued']} rescued)")
    mapper.close()
    del mapped, resolved, kept, calls, s1, s2

    work = os.path.join(ROOT, "build", "chip_smoke_pairs")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        fa = os.path.join(work, "ref.fa")
        r1, r2, c1, c2, ci = (os.path.join(work, f) for f in (
            "r1.fq", "r2.fq", "c1.fq", "c2.fq", "ci.fq"))
        t1 = time.perf_counter()
        write_fasta(fa, [("chr1", ref)])
        write_fastq_pair(r1, r2, ps)
        head = dataclasses.replace(ps, **{
            f.name: getattr(ps, f.name)[:CHUNK]
            for f in dataclasses.fields(ps)})
        write_fastq_pair(c1, c2, head)
        write_fastq_pair(None, None, head, interleaved_path=ci)
        log(f"paired map_fastq: wrote the reference as one contig and "
            f"{N_PAIRS:,} pairs as R1/R2 files, the first {CHUNK:,} also "
            f"interleaved, in {time.perf_counter() - t1:.2f} s")
        out = os.path.join(work, "pairs.sam")
        dt, err, launches, n_build = _map_fastq_run(
            [fa, "--r1", r1, "--r2", r2, "-o", out, "--chunk-reads",
             str(CHUNK)], "--r1 --r2")
        # a FASTQ chunk of CHUNK pairs is two engine chunks of reads
        _check_launches("map_fastq --r1 --r2", "compacted", launches,
                        minimizer=n_build + 2 * -(-N_PAIRS // CHUNK),
                        also=("affine_wf_dist",))
        done = [ln for ln in err.splitlines() if ln.startswith("done:")][0]
        m = re.search(r"; (\d+) reads/s mapping", done)
        with open(out) as f:
            text = f.read()
        body = [ln for ln in text.splitlines() if not ln.startswith("@PG")]
        stats = validate_sam(text, expect_reads=2 * N_PAIRS,
                             require_mapq=True)
        acc = _sam_pair_accuracy(text, ps, keep)
        log(f"map_fastq --r1 --r2: {dt:.2f} s wall = "
            f"{2 * N_PAIRS / dt:,.0f} reads/s with the FASTA load and "
            f"index build, {int(m.group(1)):,} reads/s mapping, pairing "
            f"and SAM without them; validate_sam passed "
            f"({stats['n_mapped']:,} mapped, {stats['n_proper']:,} proper "
            f"records); accuracy from the SAM {acc:.5f}; launches "
            f"{launches}, minimizer_scan {n_build} of them in the index "
            f"build")
        log(f"  {done}")
        log("  " + [ln for ln in err.splitlines()
                    if ln.startswith("pairing:")][0])
        if acc < PAIR_ACCURACY_BAR:
            raise AssertionError(f"map_fastq --r1 --r2: accuracy {acc} "
                                 f"below {PAIR_ACCURACY_BAR}")
        n_head = sum(ln.startswith("@") for ln in body)
        for what, inputs, engine, kernels in (
                ("--engine fused", ["--r1", c1, "--r2", c2, "--engine",
                                    "fused"], "fused", True),
                ("--engine padded", ["--r1", c1, "--r2", c2, "--engine",
                                     "padded"], "padded", True),
                ("--interleaved", [ci, "--interleaved"], "compacted", True),
                ("--wf-backend torch", ["--r1", c1, "--r2", c2,
                                        "--wf-backend", "torch"], None,
                 False)):
            out = os.path.join(work, "first.sam")
            dt, _, launches, n_build = _map_fastq_run(
                [fa, *inputs, "-o", out, "--chunk-reads", str(CHUNK)],
                what, kernels=kernels)
            if kernels:
                _check_launches(f"map_fastq {what}", engine, launches,
                                minimizer=n_build + (1 if engine == "padded"
                                                     else 2),
                                also=("affine_wf_dist",))
            elif any(launches[name] for name in MAPPER_KERNELS):
                raise AssertionError(f"map_fastq {what} launched kernels: "
                                     f"{launches}")
            with open(out) as f:
                got = [ln for ln in f.read().splitlines()
                       if not ln.startswith("@PG")]
            if got != body[: n_head + 2 * CHUNK]:
                raise AssertionError(f"map_fastq {what}: its SAM differs "
                                     f"from the first chunk of --r1 --r2's")
            log(f"map_fastq {what} on the first {CHUNK:,} pairs: "
                f"{dt:.2f} s wall (index build included); its SAM equals "
                f"the header and first {2 * CHUNK:,} records of --r1 "
                f"--r2's apart from @PG; launches {launches}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path, rescue, ps


def _scanned_tiles(man):
    """Tiles of a sharded build that ran the minimizer scan: every tile
    whose window (its bases and the w - 1 before) holds a whole window of
    w k-mers, the last one only if its bases reach k."""
    b = man["build"]
    last = man["ref_len"] - man["origin"] - (b["tiles"] - 1) * b["tile_bp"]
    short = b["tiles"] > 1 and last < man["k"]
    return b["tiles"] - int(short)


def _build_index_run(args, what, kernels=True):
    """``launch.build_index.main(args)`` in-process -> (wall s, its
    manifest, its stderr), checking that it launched the minimizer kernel
    once a scanned tile (with ``kernels``) or never, and no other
    kernel."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import build_index
    err = io.StringIO()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = build_index.main(args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"build_index {what}: exit {rc}\n"
                             f"{err.getvalue()}")
    with open(os.path.join(args[args.index("-o") + 1],
                           "manifest.json")) as f:
        man = json.load(f)
    want = _scanned_tiles(man) if kernels else 0
    if launches["minimizer_scan"] != want or any(
            launches[n] for n in MAPPER_KERNELS if n != "minimizer_scan"):
        raise AssertionError(f"build_index {what}: launches {launches}, "
                             f"not minimizer_scan {want} times alone "
                             f"({man['build']['tiles']} tiles)")
    return dt, man, err.getvalue(), launches["minimizer_scan"]


def _map_fastq_index_run(args, what):
    """``map_fastq.main(args)`` over ``--index-dir`` in-process -> (wall s,
    its stderr, the launches during it)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import map_fastq
    err = io.StringIO()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = map_fastq.main(args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"map_fastq {what}: exit {rc}\n{err.getvalue()}")
    return dt, err.getvalue(), dict(ops.LAUNCHES)


def _routed_map(idx, reads, what, **kw):
    """``Mapper(idx, **kw).map(reads)`` on the card, compacted engine ->
    (result, wall s, launches); every kernel of the engine launched, the
    minimizer scan once a chunk."""
    import torch
    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pipeline import MapperConfig
    from repro_torch.kernels import ops
    cfg_kw = {k: kw.pop(k) for k in ("chunk_reads",) if k in kw}
    cfg = MapperConfig.from_index(idx, both_strands=True, **cfg_kw)
    with Mapper(idx, cfg, **kw) as mapper:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = mapper.map(reads)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    _check_launches(what, "compacted", launches,
                    minimizer=res.stats["n_chunks"])
    return res, dt, launches


def _same_fields(what, a, b):
    for f in FIELDS + ("linear_dist",):
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: {f} differs")


def phase_sharded(ref, rs, mf, work):
    """Phase 11, the sharded index, each step fatal: phase 7's FASTA built
    by ``launch.build_index`` (the kernel once a tile, ``--verify``, a
    ``--wf-backend torch`` build with equal digests); ``map_fastq
    --index-dir`` on phase 7's FASTQ per engine (SAM equal to phase 7's);
    the arena's write order under a budget that evicts while chunks are
    in flight; an origin build straddling 2^31.  -> {step: launches} for
    the kernels JSON line."""
    from repro_torch.data.genome import sample_reads, write_fasta
    from repro_torch.index import build_sharded_index, open_index
    from repro_torch.kernels import ops

    out = {}
    # 1. the build, on the kernel and on the plain route
    idx_dir = os.path.join(work, "idx")
    dt, man, err, n_scan = _build_index_run(
        [mf["fa"], "-o", idx_dir, "--partitions", str(SHARD_PARTS),
         "--verify"], "--verify")
    if "full integrity check passed" not in err:
        raise AssertionError(f"build_index --verify:\n{err}")
    bases = man["ref_len"] - man["origin"]
    log(f"build_index: {bases:,} bases, {SHARD_PARTS} partitions, "
        f"{man['build']['n_occurrences']:,} occurrences in {dt:.2f} s "
        f"({bases / dt:,.0f} bases/s) with --verify; minimizer_scan "
        f"{n_scan} launches for {man['build']['tiles']} tiles of "
        f"{man['build']['tile_bp']:,}")
    out["build_tiles"] = n_scan
    plain_dir = os.path.join(work, "idx_plain")
    dt_t, man_t, _, _ = _build_index_run(
        [mf["fa"], "-o", plain_dir, "--partitions", str(SHARD_PARTS),
         "--wf-backend", "torch"], "--wf-backend torch", kernels=False)
    if (man_t["reference"] != man["reference"]
            or [p["files"] for p in man_t["partitions"]]
            != [p["files"] for p in man["partitions"]]):
        raise AssertionError("build_index --wf-backend torch: digests "
                             "differ from the kernel route's")
    shutil.rmtree(plain_dir)
    log(f"build_index --wf-backend torch: {dt_t:.2f} s, no kernel "
        f"launched; every file's crc32 equals the kernel route's")

    # 2. map_fastq --index-dir on phase 7's FASTQ
    chunks = -(-N_READS // CHUNK)
    out["map_fastq"] = {}
    for engine in ("compacted", "fused"):
        sam = os.path.join(work, f"index_{engine}.sam")
        dt, err, launches = _map_fastq_index_run(
            ["--index-dir", idx_dir, mf["fq"], "-o", sam, "--engine", engine,
             "--chunk-reads", str(CHUNK)], f"--index-dir --engine {engine}")
        _check_launches("map_fastq --index-dir", engine, launches,
                        minimizer=chunks)
        with open(sam) as f:
            body = [ln for ln in f.read().splitlines()
                    if not ln.startswith("@PG")]
        os.remove(sam)
        if body != mf["body"]:
            raise AssertionError(f"map_fastq --index-dir --engine {engine}: "
                                 f"the SAM differs from phase 7's")
        part = [ln for ln in err.splitlines()
                if ln.startswith("partitions:")]
        log(f"map_fastq --index-dir --engine {engine}: {dt:.2f} s wall = "
            f"{N_READS / dt:,.0f} reads/s (index opened, not built); SAM "
            f"equals phase 7's in-memory one apart from @PG; launches "
            f"{launches}")
        log(f"  {part[0] if part else err}")
        out["map_fastq"][engine] = launches

    # 3. write order: chunks of one read over 64 partitions under half
    # the index, with prefetch, against the whole index resident
    dir64 = os.path.join(work, "idx64")
    dt, man64, _, _ = _build_index_run(
        [mf["fa"], "-o", dir64, "--partitions", str(EVICT_PARTS)],
        f"--partitions {EVICT_PARTS}")
    idx64 = open_index(dir64)
    reads = rs.reads[:EVICT_READS]
    base, dt_b, _ = _routed_map(idx64, reads, "whole index", chunk_reads=1)
    rows = sum(p.n_occurrences for p in idx64.parts)
    budget = rows // 2 * (idx64.seg_len + 4)
    got, dt_e, launches = _routed_map(
        idx64, reads, "evicting, prefetch", chunk_reads=1,
        memory_budget_bytes=budget, prefetch=True)
    _same_fields("evicting run with prefetch", got, base)
    part = got.stats["partitions"]
    if part["partition_evictions"] < 1 or part["prefetch_loads"] < 1:
        raise AssertionError(f"evicting run: {part}")
    log(f"write order: {EVICT_PARTS} partitions ({man64['build']['n_occurrences']:,} "
        f"occurrences, built in {dt:.2f} s), {EVICT_READS} reads a read a "
        f"chunk on both strands, budget {budget:,} B (half the index) with "
        f"prefetch: {part['partition_loads']} loads "
        f"({part['prefetch_loads']} prefetched, {part['prefetch_hits']} "
        f"prefetch hits), {part['partition_evictions']} evictions, "
        f"{part['partition_compactions']} compactions, "
        f"{part['h2d_bytes']:,} B h2d in {dt_e:.2f} s (whole index "
        f"resident: {dt_b:.2f} s); every result field equals the whole "
        f"index's")
    out["evicting"] = launches
    shutil.rmtree(dir64)
    del idx64

    # 4. an origin build straddling 2^31, mapped on the card
    sub = ref[:ORIGIN_BASES]
    fa_o = os.path.join(work, "origin.fa")
    write_fasta(fa_o, [("chrO", sub)])
    rs_o = sample_reads(sub, ORIGIN_READS, seed=3, both_strands=True)
    res_o = {}
    for origin in (0, ORIGIN):
        d = os.path.join(work, f"idx_origin{origin}")
        ops.reset_launch_counts()
        idx_o = build_sharded_index(fa_o, d, num_partitions=SHARD_PARTS,
                                    origin=origin)
        res_o[origin], _, launches = _routed_map(idx_o, rs_o.reads,
                                                 f"origin {origin}")
    a, b = res_o[0], res_o[ORIGIN]
    m = a.mapped
    if not (np.array_equal(b.mapped, m)
            and np.array_equal(b.position[m], a.position[m] + ORIGIN)
            and (b.position[~m] == -1).all()):
        raise AssertionError("origin build: positions are not the origin-0 "
                             "build's shifted by the origin")
    for f in ("distance", "distance2", "strand", "ops", "op_count"):
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"origin build: {f} differs")
    ok = ((np.abs(b.position - (rs_o.true_pos.astype(np.int64) + ORIGIN))
            <= ETH)
          & (b.strand == rs_o.strand))
    if ok.mean() < ACCURACY_BAR:
        raise AssertionError(f"origin build: accuracy {ok.mean()}")
    if not ((b.position[m] >= 2**31).any()
            and (b.position[m] < 2**31).any()):
        raise AssertionError("origin build: the mapped positions do not "
                             "straddle 2^31")
    log(f"origin build: {ORIGIN_BASES:,} bases at origin {ORIGIN:,} "
        f"(positions {int(b.position[m].min()):,}..{int(b.position.max()):,}"
        f", int32 words in the arena), {ORIGIN_READS:,} reads: equal to "
        f"the origin-0 build's shifted by the origin; accuracy "
        f"{ok.mean():.5f}")
    out["origin"] = launches

    return out


def _same_slice(what, got, want, lo, hi):
    """``got`` (a request's result) equals rows [lo, hi) of ``want`` in
    every field ``want`` holds."""
    for f in FIELDS + ("linear_dist",):
        b = getattr(want, f)
        a = getattr(got, f)
        if b is None:
            if a is not None:
                raise AssertionError(f"{what}: {f} is set, the plain run's "
                                     f"is None")
            continue
        if not np.array_equal(a, b[lo:hi]):
            raise AssertionError(f"{what}: {f} differs from the plain "
                                 f"run's rows [{lo}, {hi})")
    if got.failed is not None and got.failed.any():
        raise AssertionError(f"{what}: {int(got.failed.sum())} reads "
                             f"quarantined on a healthy run")


def _service_load(rng, n_reads, n_paired):
    """Request sizes of 1 to SVC_MAX_REQUEST reads, log-uniform, covering
    ``n_reads``; and the request indices after which each of the
    ``n_paired`` paired requests is submitted."""
    sizes = []
    while sum(sizes) < n_reads:
        sizes.append(min(int(np.exp(rng.uniform(
            0, np.log(SVC_MAX_REQUEST + 1)))), SVC_MAX_REQUEST,
            n_reads - sum(sizes)))
    return sizes, sorted(rng.choice(len(sizes), n_paired, replace=False))


def _run_service(idx, engine, rs, pairs, sizes, after):
    """One engine's service run on the load; checks it against a plain
    ``Mapper.map`` / ``map_pairs`` -> the run's launches."""
    import torch
    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pipeline import MapperConfig
    from repro_torch.core.serving import BatcherConfig
    from repro_torch.kernels import ops
    from repro_torch.obs import registry as obs_registry

    cfg = MapperConfig.from_index(idx, both_strands=True, chunk_reads=CHUNK,
                                  engine=engine, cigar_mode="eager")
    r1 = pairs.reads1[:SVC_PAIRED * SVC_PAIRS]
    r2 = pairs.reads2[:SVC_PAIRED * SVC_PAIRS]
    plain = Mapper(idx, cfg)
    want = plain.map(rs.reads)
    want1, want2 = plain.map_pairs(r1, r2)
    plain.close()
    mapper = Mapper(idx, cfg)
    svc = mapper.serve(BatcherConfig(bucket_min=SVC_BUCKET_MIN,
                                     bucket_max=CHUNK))
    reg = obs_registry.enable_metrics(obs_registry.MetricsRegistry())
    spans, results, pending, lo, p = {}, {}, 0, 0, 0
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        for i, n in enumerate(sizes):
            spans[svc.submit(rs.reads[lo:lo + n])] = ("single", lo, lo + n)
            lo += n
            pending += n
            while p < len(after) and after[p] == i:
                a, b = p * SVC_PAIRS, (p + 1) * SVC_PAIRS
                spans[svc.submit_paired(r1[a:b], r2[a:b])] = ("paired", a, b)
                pending += 2 * SVC_PAIRS
                p += 1
            if pending >= SVC_BURST or i == len(sizes) - 1:
                results.update(svc.flush())
                pending = 0
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        obs_registry.disable_metrics()
    launches = dict(ops.LAUNCHES)
    what = f"MappingService --engine {engine}"
    _check_launches(what, engine, launches)
    if sorted(results) != sorted(spans):
        raise AssertionError(f"{what}: {len(results)} requests resolved of "
                             f"{len(spans)}")
    for rid, (kind, a, b) in spans.items():
        got = results[rid]
        if kind == "single":
            _same_slice(f"{what} request {rid}", got, want, a, b)
        else:
            _same_slice(f"{what} paired request {rid} R1", got[0], want1,
                        a, b)
            _same_slice(f"{what} paired request {rid} R2", got[1], want2,
                        a, b)
    misses = mapper.plan_cache_misses
    bound = int(math.log2(CHUNK // SVC_BUCKET_MIN)) + 1
    if misses > bound:
        raise AssertionError(f"{what}: {misses} plan-cache misses, more "
                             f"than log2({CHUNK}/{SVC_BUCKET_MIN}) + 1 = "
                             f"{bound}")
    rm = svc.resilient
    if rm.ladder.level or any(rm.counters.values()):
        raise AssertionError(f"{what}: a healthy run left rung 0: "
                             f"{rm.ladder.describe()}, {rm.counters}")
    h = reg.histogram("repro_bucket_execute_seconds")
    n_reads = len(rs.reads) + 2 * len(r1)
    log(f"{what}: {len(spans):,} requests ({len(sizes):,} single-end, "
        f"{len(after)} paired of {SVC_PAIRS} pairs), {n_reads:,} reads in "
        f"{dt:.3f} s = {len(spans) / dt:,.0f} requests/s, "
        f"{n_reads / dt:,.0f} reads/s; {h.count} bucket executions, p50 "
        f"{h.quantile(0.5):.4g} s, p99 {h.quantile(0.99):.4g} s (bucket "
        f"upper edges); plan cache {mapper.plan_cache_hits} hits / {misses} "
        f"misses (at most {bound}); batcher {svc.batcher.stats['bucket_hist']}"
        f", padding {svc.batcher.stats['padded_reads']:,} reads; launches "
        f"{launches}; every request equals the plain run's rows, rung 0")
    mapper.close()
    return launches


class _PlanOnly:
    """A session that maps nothing: ``ResilientMapper`` over it, driven by
    an injector alone, quarantines the blocks that the injector's spec
    makes the bisection quarantine (``tests/test_torch_resilience.py``
    holds the same code to the reference's)."""

    def __init__(self, cfg):
        import torch
        self.cfg, self.device = cfg, torch.device("cpu")

    def plan(self, n, chunk=None):
        return n

    def run(self, n, reads):
        return type("Rows", (), dict(position=np.zeros(n)))

    def with_config(self, cfg):
        return _PlanOnly(cfg)


def _quarantine(segments):
    from repro_torch.core.resilience import BlockFailure
    return np.concatenate([np.full(n, isinstance(s, BlockFailure))
                           for n, s in segments])


def _run_resilient(idx, reads, clean, engines):
    """A ``ResilientMapper`` on ``reads`` with ``RESILIENT_SPEC`` and the
    fused engine, ``engines`` marked failing: one step down; with the
    ``cuda`` backend marked failing every row is quarantined on the last
    rung and no kernel runs.  -> its launches."""
    import dataclasses

    import torch
    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pipeline import MapperConfig
    from repro_torch.core.resilience import (FaultInjector, ResilientMapper,
                                             RetryPolicy)
    from repro_torch.kernels import ops

    spec = f"{RESILIENT_SPEC},engines={engines}"
    policy = RetryPolicy(max_attempts=3, backoff_s=0.0, degrade_after=3)
    cfg = MapperConfig.from_index(idx, both_strands=True, chunk_reads=CHUNK,
                                  engine="fused", cigar_mode="eager")
    with contextlib.redirect_stderr(io.StringIO()):   # its descents
        want, want_counters = ResilientMapper(
            _PlanOnly(cfg), policy,
            FaultInjector.from_spec(spec)).map_segments(reads)
    want = _quarantine(want)
    inj = FaultInjector.from_spec(spec)
    rm = ResilientMapper(Mapper(idx, cfg, injector=inj), policy, inj)
    err = io.StringIO()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        res, mask, counters = rm.map(reads)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    what = f"ResilientMapper engines={engines}"
    if not np.array_equal(mask, want):
        raise AssertionError(f"{what}: quarantined rows "
                             f"{np.flatnonzero(mask)[:40]}, the bisection "
                             f"quarantines {np.flatnonzero(want)[:40]}")
    if counters != want_counters or counters["degraded_steps"] != 1 \
            or rm.ladder.level != 1:
        raise AssertionError(f"{what}: {counters}, ladder "
                             f"{rm.ladder.describe()}; the bisection's "
                             f"{want_counters}, one step down")
    backends = {c.wf_backend for c in rm.ladder.rungs}
    if backends != {"cuda"}:
        raise AssertionError(f"{what}: ladder rungs on {backends}")
    if "cuda" in engines.split(";"):
        if res is not None or not mask.all() or any(launches.values()):
            raise AssertionError(f"{what}: {int(mask.sum())} of "
                                 f"{len(reads)} rows quarantined, launches "
                                 f"{launches}; every row must be, with no "
                                 f"launch")
    else:
        ok = ~mask
        for f in FIELDS:
            if not np.array_equal(getattr(res, f)[ok],
                                  getattr(clean, f)[ok]):
                raise AssertionError(f"{what}: healthy rows differ in {f}")
        _check_launches(what, rm.cfg.engine, launches)
    descents = [ln for ln in err.getvalue().splitlines()
                if "engine ladder down to" in ln]
    if len(descents) != 1:
        raise AssertionError(f"{what}: {len(descents)} descents written to "
                             f"stderr: {err.getvalue()}")
    log(f"{what}: {len(reads):,} reads in {dt:.3f} s; quarantined "
        f"{int(mask.sum())} rows {np.flatnonzero(mask).tolist()[:8]}... "
        f"(the bisection's, from the spec alone), counters {counters}, "
        f"ladder {rm.ladder.describe()}, fired {inj.fired}; healthy rows "
        f"equal the clean run, no rung off the cuda backend; launches "
        f"{launches}")
    for ln in descents:
        log(f"  {ln}")
    return launches


def _run_watchdog(idx, reads, clean):
    """A fetch stall of STALL_S past a watchdog of WATCHDOG_S: the error
    within WATCHDOG_S + 5 s, then a clean run on the same session.  ->
    the threads it left running: the abandoned fetch worker, which holds
    its chunk's device outputs until its stall ends."""
    import threading

    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pipeline import MapperConfig
    from repro_torch.core.resilience import FaultInjector
    from repro_torch.core.streaming import FetchStallError

    class StallOnce(FaultInjector):
        def __init__(self):
            super().__init__(stall_s=STALL_S, rates={"fetch_stall": 1.0})
            self.shots = 1

        def fire(self, site):
            if site == "fetch_stall" and self.shots > 0:
                self.shots -= 1
                return True
            return False

    cfg = MapperConfig.from_index(idx, both_strands=True, chunk_reads=CHUNK)
    mapper = Mapper(idx, cfg, injector=StallOnce(), watchdog_s=WATCHDOG_S)
    known = set(threading.enumerate())
    t0 = time.perf_counter()
    try:
        mapper.map(reads)
    except FetchStallError as e:
        dt = time.perf_counter() - t0
        msg = str(e)
    else:
        raise AssertionError("a stalled fetch did not trip the watchdog")
    if dt > WATCHDOG_S + 5:
        raise AssertionError(f"the watchdog took {dt:.2f} s")
    t1 = time.perf_counter()
    again = mapper.map(reads)
    dt2 = time.perf_counter() - t1
    for f in FIELDS:
        if not np.array_equal(getattr(again, f), getattr(clean, f)):
            raise AssertionError(f"the run after the stall differs in {f}")
    mapper.close()
    log(f"watchdog: a {STALL_S:.0f} s fetch stall raised FetchStallError "
        f"after {dt:.3f} s (watchdog {WATCHDOG_S} s; {msg!r}); the next "
        f"run on the same session took {dt2:.3f} s and equals the clean "
        f"run")
    return [t for t in threading.enumerate()
            if t not in known and t.is_alive()]


def _run_map_fastq_obs(mf, work):
    """``map_fastq --no-stream --trace-out --metrics-out --log-json`` on
    phase 7's files, compacted: the SAM equals phase 7's, the trace and
    the snapshots validate, the closing counts are the registry's, and
    the trace splits the wall time by stage.  -> its launches."""
    from repro_torch.obs.validate import (load_json, validate_chrome_trace,
                                          validate_jsonl)
    out, trace, metrics = (os.path.join(work, f) for f in
                           ("obs.sam", "trace.json", "metrics.jsonl"))
    dt, err, launches, n_build = _map_fastq_run(
        [mf["fa"], mf["fq"], "-o", out, "--chunk-reads", str(CHUNK),
         "--no-stream", "--trace-out", trace, "--metrics-out", metrics,
         "--log-json"], "--trace-out --metrics-out --log-json")
    what = "map_fastq --trace-out"
    _check_launches(what, "compacted", launches,
                    minimizer=n_build + -(-N_READS // CHUNK))
    with open(out) as f:
        body = [ln for ln in f.read().splitlines()
                if not ln.startswith("@PG")]
    if body != mf["body"]:
        raise AssertionError(f"{what}: the SAM differs from phase 7's")
    tr = load_json(trace)
    bad = validate_chrome_trace(tr) + validate_jsonl(
        metrics, load_json(os.path.join(ROOT, "schemas",
                                        "metrics_snapshot.schema.json")))
    if bad:
        raise AssertionError(f"{what}: {bad[:5]}")
    with open(metrics) as f:
        last = json.loads(f.read().splitlines()[-1])["counters"]
    line = [ln for ln in err.splitlines()
            if ln.startswith("filter/affine [single]:")][0]
    got = [int(x) for x in re.findall(r"\d+", line)[:3]]
    want = [last[f'repro_{f}_total{{topology="single"}}'] for f in
            ("survivors", "affine_instances", "padded_affine_instances")]
    if got != want:
        raise AssertionError(f"{what}: closing line {got}, registry {want}")
    events = [json.loads(ln)["event"] for ln in err.splitlines()
              if ln.startswith("{")]
    if events[0] != "start" or events[-1] != "done" or \
            events.count("chunk") != -(-N_READS // CHUNK):
        raise AssertionError(f"{what}: JSON events {events}")
    split = {}
    for e in tr["traceEvents"]:
        if e["ph"] == "X":
            split[e["name"]] = split.get(e["name"], 0.0) + e["dur"] / 1e6
    order = ("ingest", "host_prep", "h2d", "seed", "linear", "affine",
             "traceback", "d2h", "sam_emit")
    traced = sum(split.get(k, 0.0) for k in order)
    log(f"{what}: {dt:.2f} s wall (index build included); the SAM equals "
        f"phase 7's; trace and snapshots valid; closing counts are the "
        f"registry's {want}; {len(events)} JSON events")
    log("  wall-time split (s, trace spans, --no-stream): " + ", ".join(
        f"{k} {split.get(k, 0.0):.4f}" for k in order)
        + f"; {traced:.3f} s traced, {dt - traced:.3f} s elsewhere (FASTA "
        f"load, index build, result assembly)")
    return launches


def _run_memory(idx, reads):
    """Device memory of a compacted run over 1, 4 and 16 chunks of
    MEM_CHUNK reads: each run leaves allocated what it found (no tensor
    outlives its chunk), and the 16-chunk peak may pass the 4-chunk one by
    at most one chunk's tensors (the 1-chunk run's peak over what was
    allocated before it)."""
    import torch
    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pipeline import MapperConfig
    cfg = MapperConfig.from_index(idx, both_strands=True,
                                  chunk_reads=MEM_CHUNK)
    mapper = Mapper(idx, cfg)
    mapper.map(reads[:MEM_CHUNK])
    peaks, held = {}, {}
    for n_chunks in (1, 4, 16):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mapper.map(reads[:n_chunks * MEM_CHUNK])
        torch.cuda.synchronize()
        peaks[n_chunks] = torch.cuda.max_memory_allocated()
        held[n_chunks] = (base, torch.cuda.memory_allocated())
    mapper.close()
    one = peaks[1] - held[1][0]
    log(f"device memory: peak {peaks[1]:,} / {peaks[4]:,} / {peaks[16]:,} B "
        f"over 1 / 4 / 16 chunks of {MEM_CHUNK:,} reads; allocated before "
        f"and after each run {held}; one chunk's tensors {one:,} B")
    kept = {n: after - before for n, (before, after) in held.items()
            if after != before}
    if kept:
        raise AssertionError(f"device memory outlives the run: {kept} B "
                             f"still allocated after n-chunk runs")
    if peaks[16] > peaks[4] + one:
        raise AssertionError(f"device memory grows with the stream: "
                             f"{peaks[16]:,} B over 16 chunks, {peaks[4]:,} "
                             f"B over 4, one chunk {one:,} B")


def _median_s(fn, rounds):
    import torch
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return float(np.median(out)), out


def _run_overheads(idx, reads):
    """Printed, not checked: an armed-but-idle ``ResilientMapper`` against
    ``Mapper.map``, and the metrics registry, the tracer and both armed
    against none, on every read, compacted, in alternating rounds."""
    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pipeline import MapperConfig
    from repro_torch.core.resilience import ResilientMapper
    from repro_torch.obs import registry as obs_registry
    from repro_torch.obs import tracing as obs_tracing
    cfg = MapperConfig.from_index(idx, both_strands=True, chunk_reads=CHUNK)
    mapper = Mapper(idx, cfg)
    rm = ResilientMapper(mapper)
    mapper.map(reads[:CHUNK])

    def armed(metrics, tracing):
        def run():
            if metrics:
                obs_registry.enable_metrics(obs_registry.MetricsRegistry())
            if tracing:
                obs_tracing.enable_tracing(tracer_=obs_tracing.Tracer())
            try:
                mapper.map(reads)
            finally:
                obs_registry.disable_metrics()
                obs_tracing.disable_tracing()
        return run
    runs = {"plain": lambda: mapper.map(reads),
            "resilient": lambda: rm.map(reads),
            "metrics": armed(True, False), "tracing": armed(False, True),
            "both": armed(True, True)}
    times = {k: [] for k in runs}
    for _ in range(OVERHEAD_ROUNDS):
        for k, fn in runs.items():
            times[k] += _median_s(fn, 1)[1]
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"overheads, {len(reads):,} reads, compacted, median of "
        f"{OVERHEAD_ROUNDS} alternating rounds: Mapper.map "
        f"{med['plain']:.4f} s; "
        + "; ".join(f"{k} {med[k]:.4f} s ({med[k] / med['plain'] - 1:+.2%})"
                    for k in runs if k != "plain")
        + "; rounds "
        + json.dumps({k: [round(x, 4) for x in v] for k, v in times.items()}))
    mapper.close()


def phase_service(idx, rs, pairs, mf, work):
    """Phase 12, serving, resilience and observability on phase 4's index,
    each check fatal (the overheads only printed).  -> {step: launches}
    for the kernels JSON line."""
    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pipeline import MapperConfig

    rng = np.random.default_rng(SVC_SEED)
    sizes, after = _service_load(rng, N_READS, SVC_PAIRED)
    out = {}
    for engine in ("compacted", "fused"):
        out[f"MappingService {engine}"] = _run_service(
            idx, engine, rs, pairs, sizes, after)
    reads = rs.reads[:CHUNK]
    clean = Mapper(idx, MapperConfig.from_index(
        idx, both_strands=True, chunk_reads=CHUNK)).map(reads)
    for engines in ("fused", "fused;cuda"):
        out[f"ResilientMapper engines={engines}"] = _run_resilient(
            idx, reads, clean, engines)
    stalled = _run_watchdog(idx, rs.reads[:2 * CHUNK], Mapper(
        idx, MapperConfig.from_index(idx, both_strands=True,
                                     chunk_reads=CHUNK)).map(
        rs.reads[:2 * CHUNK]))
    t_stall = time.perf_counter()
    out["map_fastq --trace-out"] = _run_map_fastq_obs(mf, work)
    # device memory is measured once the abandoned fetch worker has
    # ended and freed its chunk's outputs
    if not stalled:
        raise AssertionError("the watchdog left no abandoned fetch worker")
    for t in stalled:
        t.join(timeout=STALL_S + 10)
        if t.is_alive():
            raise AssertionError(f"the abandoned fetch worker {t.name} "
                                 f"outlived its {STALL_S} s stall by 10 s")
    log(f"watchdog: {len(stalled)} abandoned fetch worker(s) ended "
        f"{time.perf_counter() - t_stall:.2f} s after the step")
    _run_memory(idx, rs.reads)
    _run_overheads(idx, rs.reads)
    return out


def _mesh_map(m, reads, what):
    """The mesh session ``m`` on ``reads`` once -> (result, seconds,
    launches, peak device GB)."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = m.map(reads)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    st = res.stats
    log(f"mesh {what}: {len(reads):,} reads in {dt:.3f} s; dropped send "
        f"{st.dropped_send}, affine {st.dropped_affine}; stage-B survivors "
        f"{st.survivors:,} of {st.candidates:,} entries, capacity "
        f"{st['stage_b_affine_capacity']:,}/shard; peak device memory "
        f"{peak:.3f} GB; launches {launches}")
    return res, dt, launches, peak


def _mesh_same(what, got, want, fields=("position", "distance", "strand")):
    for f in fields:
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            bad = int((getattr(got, f) != getattr(want, f)).sum())
            raise AssertionError(f"mesh {what}: {f} differs on {bad} reads")


def _mesh_right(res, rs):
    """Per read: position within eth of the truth, on the right strand."""
    return ((np.abs(res.position - rs.true_pos) <= ETH)
            & (res.strand == rs.strand))


def _sam_fields(lines):
    """{read name: (RNAME, POS, reverse?)} of the mapped records, and the
    set of their CIGARs."""
    out, cigars = {}, set()
    for ln in lines:
        if ln.startswith("@"):
            continue
        f = ln.split("\t", 6)
        if not int(f[1]) & 0x4:
            out[f[0]] = (f[2], f[3], bool(int(f[1]) & 0x10))
            cigars.add(f[5])
    return out, cigars


def _leading_deletions(res):
    """Per read of the result ``res`` (with its ops), the reference bases
    the SAM writer trims off the front of its alignment: the shift of
    ``io.cigar.trim_edge_deletions``, 0 where none or unmapped."""
    from repro_torch.core.encoding import OP_DEL
    from repro_torch.io.cigar import (cigar_from_ops, parse_cigar,
                                      trim_edge_deletions)
    ops, cnt = np.asarray(res.ops), np.asarray(res.op_count)
    L = ops.shape[1]
    first = np.take_along_axis(ops, np.clip(L - cnt, 0, L - 1)[:, None],
                               axis=1)[:, 0]
    lead = np.zeros(len(cnt), dtype=np.int64)
    for i in np.flatnonzero((cnt > 0) & (cnt <= L) & (first == OP_DEL)):
        cig = cigar_from_ops(ops[i], int(cnt[i]))
        if cig != "*":
            lead[i] = trim_edge_deletions(parse_cigar(cig))[1]
    return lead


def _mesh_cli(idx, ref, rs, lead, pairs, mf, work):
    """``map_fastq --topology mesh --shards 8`` on phase 7's files and on
    phase 7b's pairs (written again here) -> {step: launches}.  ``lead``:
    each read's leading deletion in phase 4's compacted alignment
    (``_leading_deletions``)."""
    from repro_torch.data.genome import write_fasta, write_fastq_pair
    out = {}
    sam = os.path.join(work, "mesh.sam")
    mesh_args = ["--topology", "mesh", "--shards", str(MESH_SHARDS),
                 "--chunk-reads", str(CHUNK)]
    dt, err, out["map_fastq"], n_build = _map_fastq_run(
        [mf["fa"], mf["fq"], "-o", sam, *mesh_args], "--topology mesh")
    with open(sam) as f:
        got, cigars = _sam_fields(f.read().splitlines())
    want, _ = _sam_fields(mf["body"])
    if cigars != {"*"}:
        raise AssertionError(f"map_fastq --topology mesh: CIGARs {cigars}")
    # a record whose alignment opens with a deletion has its POS moved
    # past it when its CIGAR is normalized (io.sam.trim_edge_deletions);
    # a mesh record has no CIGAR, so its POS is the mapped position — as
    # in the reference.  So each mesh POS is phase 7's less the leading
    # deletion of the read's alignment, taken from phase 4's compacted
    # result; reads over phase 7's run of N or its contig junction (where
    # phase 4's reference differs) are held to a shift of 0 to ETH bases
    # only.  Every other field must be equal.
    near_n = np.zeros(len(rs.true_pos), dtype=bool)
    for a, b in (N_RUN, (GENOME_BASES // 2, GENOME_BASES // 2)):
        near_n |= (rs.true_pos > a - N - 2 * ETH) & (rs.true_pos < b + ETH)
    shifted, loose, bad = 0, 0, []
    for k, v in got.items():
        w = want.get(k)
        i = int(k[len("read"):])
        if w is None or w[0] != v[0] or w[2] != v[2]:
            bad.append(k)
            continue
        d = int(w[1]) - int(v[1])
        if near_n[i]:
            loose += d != 0
            if not 0 <= d <= ETH:
                bad.append(k)
        elif d != lead[i]:
            bad.append(k)
        else:
            shifted += d != 0
    if bad or len(got) != len(want):
        raise AssertionError(f"map_fastq --topology mesh: {len(bad)} "
                             f"mapped records differ from phase 7's, "
                             f"{len(got)} mapped of its {len(want)}"
                             + (f" (first {bad[0]}: {got[bad[0]]} vs "
                                f"{want.get(bad[0])}, leading deletion "
                                f"{lead[int(bad[0][len('read'):])]})"
                                if bad else ""))
    done = [ln for ln in err.splitlines() if ln.startswith("done:")][0]
    log(f"map_fastq --topology mesh --shards {MESH_SHARDS}: {dt:.2f} s "
        f"wall, {len(got):,} mapped records, each with phase 7's RNAME, "
        f"strand and POS ({shifted:,} of them before phase 7's by the "
        f"leading deletion its CIGAR trims, each equal to that deletion's "
        f"length in phase 4's alignment; {int(near_n.sum())} reads over "
        f"the run of N or the contig junction held to a shift of 0 to "
        f"{ETH}, {loose} shifted), "
        f"CIGAR *; launches {out['map_fastq']}")
    log(f"  {done}")
    log("  " + [ln for ln in err.splitlines()
                if ln.startswith("stage B [mesh]")][0])
    fa = os.path.join(work, "mesh_pairs.fa")
    r1, r2 = (os.path.join(work, f"mesh_{m}.fq") for m in ("r1", "r2"))
    write_fasta(fa, [("chr1", ref)])
    write_fastq_pair(r1, r2, pairs)
    sam = os.path.join(work, "mesh_pairs.sam")
    dt, err, out["map_fastq --r1 --r2"], _ = _map_fastq_run(
        [fa, "--r1", r1, "--r2", r2, "-o", sam, *mesh_args],
        "--topology mesh --r1 --r2")
    junk = (np.random.default_rng(PAIR_SEED + 0x7777).random(N_PAIRS)
            < JUNK_FRAC)
    with open(sam) as f:
        acc = _sam_pair_accuracy(f.read(), pairs, ~junk)
    log(f"map_fastq --topology mesh --r1 --r2: {dt:.2f} s wall; "
        f"proper-pair accuracy from the SAM {acc:.5f}; launches "
        f"{out['map_fastq --r1 --r2']}")
    log("  " + [ln for ln in err.splitlines()
                if ln.startswith("pairing:")][0])
    if acc < PAIR_ACCURACY_BAR:
        raise AssertionError(f"map_fastq --topology mesh --r1 --r2: "
                             f"accuracy {acc} below {PAIR_ACCURACY_BAR}")
    return out


def _mesh_kernel_parity(m, reads, want):
    """The mesh session ``m`` on ``reads`` once more, keeping every
    kernel's inputs (``KernelInputs``; equal to ``want``, its first run),
    then each kept launch's wrapper held against its plain version on the
    same inputs and timed beside it (CUDA events; the plain version once).
    -> {kernel: launches, instances, max_abs_err, ms, plain_ms}."""
    import torch
    from repro_torch.kernels import ops
    with KernelInputs() as kept:
        again = m.map(reads)
    torch.cuda.synchronize()
    _mesh_same("run keeping its kernel inputs", again, want,
               ("position", "distance", "distance2", "strand"))
    del again
    kern = _kernels()
    out = {}
    for name, calls in kept.calls.items():
        if name == "minimizer_scan":
            def run(c):
                return ops.minimizer_scan(c, k=K, w=W, codes=True)

            def plain(c):
                return _minimizer_plain(c, K, W, codes=True)
            calls = [(c,) for c in calls]
        else:
            def run(s1, s2, mo, k=kern[name]):
                return k["run"](s1, s2, ETH, mo)

            def plain(s1, s2, mo, k=kern[name]):
                return k["plain"](s1, s2, ETH, mo)
        if not calls:
            continue
        err, ms, plain_ms = 0, 0.0, 0.0
        for c in calls:
            got = run(*c)
            torch.cuda.synchronize()
            err = max(err, _compare(f"mesh {name} R={c[0].shape[0]:,}", got,
                                    plain(*c)))
            del got
            ms += cuda_ms(lambda: run(*c), 3, 1)
            plain_ms += cuda_ms(lambda: plain(*c), 1, 0)
        rows = [int(c[0].shape[0]) for c in calls]
        out[name] = dict(launches=len(calls), instances=rows,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms)
        log(f"mesh {name} on the main run's inputs: {len(calls)} launches "
            f"of {rows} rows, bit-identical to the plain version; "
            f"{ms:.4f} ms, plain {plain_ms:.2f} ms")
    for name in ("minimizer_scan", "linear_wf", "affine_wf_dist"):
        if name not in out:
            raise AssertionError(f"mesh: no {name} input kept")
    del kept
    torch.cuda.empty_cache()
    return out


def _mesh_service(m, rs, whole):
    """A ``MappingService`` on the mesh session ``m`` fed the first
    MESH_REQUESTS of phase 12's requests twice: every request equals its
    rows of ``whole`` (the mesh ``Mapper.map``), and the second pass
    builds no new plan."""
    from repro_torch.core.serving import BatcherConfig
    sizes, _ = _service_load(np.random.default_rng(SVC_SEED), N_READS,
                             SVC_PAIRED)
    sizes = sizes[:MESH_REQUESTS]
    svc = m.serve(BatcherConfig(bucket_min=SVC_BUCKET_MIN,
                                bucket_max=CHUNK))
    misses = []
    t0 = time.perf_counter()
    for _ in range(2):
        spans, lo = {}, 0
        for n in sizes:
            spans[svc.submit(rs.reads[lo:lo + n])] = (lo, lo + n)
            lo += n
        out = svc.flush()
        for rid, (a, b) in spans.items():
            for f in ("position", "distance", "strand"):
                if not np.array_equal(getattr(out[rid], f),
                                      getattr(whole, f)[a:b]):
                    raise AssertionError(f"mesh service: request [{a}, "
                                         f"{b}) differs in {f}")
        misses.append(m.plan_cache_misses)
    dt = time.perf_counter() - t0
    if misses[1] != misses[0]:
        raise AssertionError(f"mesh service: the second pass built "
                             f"{misses[1] - misses[0]} new plans")
    log(f"mesh service: {len(sizes)} requests ({sum(sizes):,} reads) twice "
        f"in {dt:.3f} s; every request equals its rows of Mapper.map; plan "
        f"cache {m.plan_cache_hits} hits / {m.plan_cache_misses} misses, "
        f"none new in the second pass; dropped send "
        f"{svc.totals['dropped_send']}, affine {svc.totals['dropped_affine']}")


def _mesh_group(sidx1, cfg, reads, local):
    """A one-rank NCCL group on the card: the group form (the exchange
    through ``all_to_all_single``, the results through ``all_gather``) on
    the one-shard index ``sidx1`` equals the local form's session
    ``local``."""
    import socket

    import torch
    import torch.distributed as dist
    from repro_torch.core.mapper import Mapper
    from repro_torch.launch.mesh import make_genomics_mesh
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_genomics_mesh(group=dist.group.WORLD)
        got, dt, _, _ = _mesh_map(
            Mapper(sidx1, cfg, topology="mesh", mesh=mesh), reads,
            "NCCL group of one rank")
    finally:
        dist.destroy_process_group()
    want, _, _, _ = _mesh_map(local, reads, "local form, one shard")
    _mesh_same("NCCL group", got, want, ("position", "distance",
                                         "distance2", "strand"))
    if got.stats.as_dict().keys() != want.stats.as_dict().keys():
        raise AssertionError("mesh NCCL group: stats keys differ")
    log(f"mesh NCCL group of one rank on {mesh.device}: {len(reads):,} "
        f"reads in {dt:.3f} s, equal to the local form")


def phase_mesh(idx, ref, rs, single, lead, pairs, mf, work):
    """Phase 13, the mesh topology at full width: phase 4's index and its
    131,072 reads on both strands over MESH_SHARDS logical shards of the
    card, each check fatal.  ``single`` holds phase 4's compacted result,
    ``lead`` its leading deletions.  Each sharded layout is built and
    placed once; the sessions that differ only in their config share it
    (``Mapper.with_config``).  -> ({step: launches}, {kernel: its parity
    on the main run's inputs}) for the kernels JSON line."""
    import torch
    from repro_torch.core.distributed import shard_index
    from repro_torch.core.mapper import Mapper
    from repro_torch.core.pipeline import MapperConfig
    from repro_torch.index import shard_flat_index
    from repro_torch.kernels import ops

    def cfg(**kw):
        return MapperConfig.from_index(idx, both_strands=True, **kw)

    out = {}
    t0 = time.perf_counter()
    sidx = shard_index(idx, MESH_SHARDS)
    sidx1 = shard_index(idx, 1)
    main = Mapper(sidx, cfg(profile=True), topology="mesh",
                  n_shards=MESH_SHARDS)
    log(f"mesh: shard_index into {MESH_SHARDS} shards and 1, and the "
        f"{MESH_SHARDS} placed on the card: {time.perf_counter() - t0:.2f} "
        f"s ({sidx.segments.nbytes / 1e9:.3f} GB of padded segments)")
    # 1. the main run, after one warm-up, and two more rounds
    _mesh_map(main, rs.reads, "warm-up")
    times, res = [], None
    for r in range(3):
        got, dt, launches, peak = _mesh_map(main, rs.reads, f"round {r}")
        times.append(dt)
        if r == 0:
            res, out["Mapper.map"], main_peak = got, launches, peak
    st = res.stats
    if st.dropped_send or st.dropped_affine:
        raise AssertionError(f"mesh: dropped send {st.dropped_send}, "
                             f"affine {st.dropped_affine}")
    _mesh_same(f"{MESH_SHARDS} shards against the single topology", res,
               single)
    acc = float(_mesh_right(res, rs).mean())
    launches = out["Mapper.map"]
    for name in ("minimizer_scan", "linear_wf", "affine_wf_dist"):
        if launches[name] < 1:
            raise AssertionError(f"mesh: {name} never launched: {launches}")
    for name in ("affine_traceback", "affine_wf"):
        if launches[name]:
            raise AssertionError(f"mesh: {name} launched: {launches}")
    rate = [N_READS / t for t in times]
    log(f"mesh {MESH_SHARDS} shards: {N_READS:,} reads on both strands, "
        f"equal to phase 4's compacted result in position, distance and "
        f"strand; accuracy {acc:.5f}; reads/s over three rounds "
        f"{', '.join(f'{x:,.0f}' for x in rate)}; stage_times_s "
        + json.dumps({k: round(v, 4) for k, v in
                      st["stage_times_s"].items()})
        + f"; peak device memory {main_peak:.3f} GB; launches {launches}; "
        f"send_cap {st['stage_b_entries'] // MESH_SHARDS ** 2:,}, "
        f"stage-B entries {st['stage_b_entries']:,}, survivors "
        f"{st.survivors:,}, affine capacity "
        f"{st['stage_b_affine_capacity']:,}/shard")
    if acc < ACCURACY_BAR:
        raise AssertionError(f"mesh: accuracy {acc} below {ACCURACY_BAR}")
    # 2. each kernel against its plain version on the inputs the main run
    # gave it, and the all-plain route on the whole batch
    parity = _mesh_kernel_parity(main, rs.reads, res)
    plain, plain_dt, plain_l, _ = _mesh_map(
        main.with_config(cfg(wf_backend="torch")), rs.reads, "plain")
    if any(plain_l[k] for k in MAPPER_KERNELS):
        raise AssertionError(f"mesh wf_backend torch launched {plain_l}")
    _mesh_same("wf_backend torch", plain, res,
               ("position", "distance", "distance2", "strand"))
    for f in ("survivors", "dropped_send", "dropped_affine"):
        if getattr(plain.stats, f) != getattr(st, f):
            raise AssertionError(f"mesh wf_backend torch: {f} "
                                 f"{getattr(plain.stats, f)} != "
                                 f"{getattr(st, f)}")
    log(f"mesh wf_backend torch: {N_READS:,} reads in {plain_dt:.3f} s "
        f"with no launch, equal to the main run in position, distance, "
        f"distance2, strand, survivors and drops")
    del plain
    head = rs.reads[:CHUNK]
    # 3. overflow: send capacity and survivor capacity
    small, _, _, _ = _mesh_map(
        Mapper(sidx, cfg(), topology="mesh", n_shards=MESH_SHARDS,
               send_cap=MESH_SEND_CAP), rs.reads,
        f"send_cap={MESH_SEND_CAP}")
    mapped = small.position >= 0
    acc2 = float(_mesh_right(small, rs)[mapped].mean())
    if not small.stats.dropped_send or acc2 <= MESH_OVERFLOW_BAR:
        raise AssertionError(f"mesh send_cap={MESH_SEND_CAP}: dropped "
                             f"{small.stats.dropped_send}, accuracy of "
                             f"the mapped {acc2}")
    tight, _, _, _ = _mesh_map(
        main.with_config(cfg(stage_b_survivor_frac=MESH_FRAC)), head,
        f"survivor frac {MESH_FRAC}")
    if not tight.stats.dropped_affine:
        raise AssertionError(f"mesh survivor frac {MESH_FRAC}: no affine "
                             f"drop")
    log(f"mesh overflow: send_cap={MESH_SEND_CAP} dropped "
        f"{small.stats.dropped_send:,} entries, {int(mapped.sum()):,} reads "
        f"mapped at accuracy {acc2:.5f}; survivor frac {MESH_FRAC} dropped "
        f"{tight.stats.dropped_affine:,} survivors")
    del small
    # 4. one shard
    one_m = Mapper(sidx1, cfg(), topology="mesh", n_shards=1)
    one, _, out["Mapper.map, one shard"], _ = _mesh_map(
        one_m, rs.reads, "one shard")
    _mesh_same("one shard against the single topology", one, single)
    # 5. mesh placement of a partitioned index
    t0 = time.perf_counter()
    parts = shard_flat_index(idx, SHARD_PARTS)
    placed = parts.to_mesh_shards()
    hashed = shard_index(idx, SHARD_PARTS)
    for f in ("uniq_kmers", "offsets", "positions", "segments"):
        a, b = getattr(placed, f), getattr(hashed, f)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"mesh placement: {f} differs from "
                                 f"shard_index's")
    log(f"mesh placement: to_mesh_shards of a {SHARD_PARTS}-partition "
        f"shard_flat_index equals shard_index(flat, {SHARD_PARTS}) "
        f"({time.perf_counter() - t0:.2f} s with both)")
    del placed
    a, _, _, _ = _mesh_map(
        Mapper(parts, cfg(), topology="mesh", n_shards=SHARD_PARTS), head,
        "partitions placed")
    b, _, _, _ = _mesh_map(
        Mapper(hashed, cfg(), topology="mesh", n_shards=SHARD_PARTS), head,
        "flat index sharded")
    _mesh_same("partitions placed against the flat index", a, b,
               ("position", "distance", "distance2", "strand"))
    del parts, hashed
    # 6, 7. the command line, single-end and paired
    out.update({f"{k} --topology mesh": v for k, v in
                _mesh_cli(idx, ref, rs, lead, pairs, mf, work).items()})
    # 8. the service
    _mesh_service(main.with_config(cfg()), rs, res)
    # 9. the group form
    _mesh_group(sidx1, cfg(), head, one_m)
    del main, one_m
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return out, parity


def _minimizer_row(runs, generated):
    """The minimizer kernel on the inputs seeding gave it: every launch of
    each engine's run timed again on its own rows, and the compacted
    engine's first chunk held against the plain version and timed.  ->
    its kernels JSON row (with phase 6's timings and the index build's
    scan beside)."""
    import torch
    from repro_torch.kernels import ops
    name = "minimizer_scan"

    def run(seqs):
        return ops.minimizer_scan(seqs, k=K, w=W, codes=True)
    for engine, r in runs.items():
        calls = r["calls"][name]
        total = sum(cuda_ms(lambda: run(seqs), 5, 1) for seqs in calls)
        r.setdefault("kernel_ms", {})[name] = total
        log(f"main path {engine} {name}: {len(calls)} launches, rows "
            f"{[c.shape[0] for c in calls]}, device time {total:.3f} ms = "
            f"{total / 1e3 / r['wall_s']:.2%} of the run's "
            f"{r['wall_s']:.3f} s wall")
    seqs = runs["compacted"]["calls"][name][0]
    R, L = seqs.shape
    got = run(seqs)
    torch.cuda.synchronize()
    err = _compare(f"{name} main-path R={R}", got,
                   _minimizer_plain(seqs, K, W, codes=True))
    ms = cuda_ms(lambda: run(seqs), 20, 3)
    plain_ms = cuda_ms(lambda: _minimizer_plain(seqs, K, W, True), 1, 1)
    dev = device_ms(lambda: run(seqs), "minimizer_kernel")
    b_ms, b_by = minimizer_bound(R, L, K, W)
    log(f"main path {name}: first compacted chunk, R={R} rows of {L}, "
        f"k-mer codes: bit-identical to the plain version; {ms:.4f} "
        f"ms/call ({R / ms * 1e3:,.0f} rows/s), plain {plain_ms:.2f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound; device "
        f"time (torch.profiler) "
        f"{'not measured' if dev is None else f'{dev:.4f} ms'} a launch")
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/minimizer.cu",
        replaces="src/repro/kernels/minimizer.py:59",
        launches=runs["compacted"]["launches"][name], max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, device_ms=dev, instances=int(R),
        engine="compacted",
        launches_by_engine={e: r["launches"][name] for e, r in runs.items()},
        run_ms={e: r["kernel_ms"][name] for e, r in runs.items()},
        generated=generated, index_scan=runs["compacted"]["index_scan"])


def phase_mainpath_kernels(runs, generated):
    """Each mapper kernel on the inputs the main path gave it: parity and
    times on the first batch of its engine (the compacted engine's first
    chunk; the padded batch for the kernel only the padded engine runs),
    and every launch of each engine's run timed again on its own inputs.
    ``generated``: phase 6's minimizer timings, kept in its row."""
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
        if name == "linear_wf":
            i32_ms = lin_int32_ms(R, n, ETH)
            extra = f"; int32 bound {i32_ms:.4f} ms, {i32_ms / ms:.1%}"
        log(f"main path {name}: first {k['engine']} batch, R={R}: "
            f"bit-identical to the plain version; {ms:.4f} ms/call "
            f"({R / ms * 1e3:,.0f} instances/s), plain {plain_ms:.2f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound{extra}")
    rows["minimizer_scan"] = _minimizer_row(runs, generated)
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


def _plain_masked(q, k, v, keep, chunk=1024, causal=False):
    """Attention with the kernel's arithmetic over the (query, key) pairs
    that ``keep(qpos, kpos)`` allows, one softmax over all keys per chunk
    of query rows: the body of the planted faults.  ``causal``: ``keep``
    drops every key past the query, so a chunk reads only the keys up to
    its last row (those past it would add exact zeros)."""
    import torch
    from repro_torch.core.attention import NEG
    B, S, H, hd = q.shape
    KV = k.shape[2]
    kf, vf = k.float(), v.float()
    outs = []
    for i in range(0, S, chunk):
        qb = q[:, i : i + chunk].float() * (1.0 / math.sqrt(hd))
        n = qb.shape[1]
        nk = i + n if causal else S
        kpos = torch.arange(nk, device=q.device)[None, :]
        s = torch.einsum("bqgrd,bkgd->bgrqk",
                         qb.reshape(B, n, KV, H // KV, hd), kf[:, :nk])
        qpos = torch.arange(i, i + n, device=q.device)[:, None]
        kept = keep(qpos, kpos)
        s = s.masked_fill(~kept, NEG)
        # a row that keeps no key sums nothing: 0 / max(0, 1e-30) = 0
        p = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill(~kept, 0)
        o = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype).float(),
                         vf[:, :nk])
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
    return _plain_masked(q, k, v, keep, causal=causal)


def _fault_head(q, k, v, causal, q_chunk, kv_chunk):
    """Query head h reads KV head h // rep + 1 (mod KV)."""
    def keep(qp, kp):
        return (kp <= qp) if causal else (kp >= 0)
    return _plain_masked(q, k.roll(1, 2), v.roll(1, 2), keep, causal=causal)


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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_name = {}
    for _, ns, name in _device_ops(prof):
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + ns / 1e3, n + 1)
    dev = sorted(((us, n, name) for name, (us, n) in by_name.items()),
                 reverse=True)
    log(f"prefill profile: the trace read in {time.perf_counter() - t0:.2f} "
        f"s")
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


def _describe(cfg) -> str:
    """The config's widths, as its family has them."""
    if cfg.family == "ssm":
        what = (f"Mamba-1, d_inner {cfg.ssm_d_inner}, state {cfg.ssm_state},"
                f" dt rank {cfg.ssm_dt_rank}")
    else:
        what = (f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
                f"d_ff {cfg.d_ff}")
    if cfg.family == "moe":
        what += f" per expert, {cfg.n_experts} experts top-{cfg.top_k}"
    if cfg.family == "hybrid":
        what = (f"Mamba-2, d_inner {cfg.ssm_d_inner}, {cfg.ssm_heads} heads,"
                f" state {cfg.ssm_state}; one shared attention block of "
                f"{what} after every {cfg.attn_every} layers")
    return (f"{cfg.arch} at full width ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {what}, vocab {cfg.vocab_size}, norm "
            f"{cfg.norm})")


def _draw_params(arch, cast=False):
    """``arch``'s config at full width and its weights drawn on the card
    from seed 0 (``cast``: the matrices stored in bf16, as the forward
    casts them).  -> (cfg, params)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), cast=cast)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"LM: {_describe(cfg)}: {n_params:,} parameters ({n_bytes / 1e9:.3f}"
        f" GB) drawn on the card from seed 0 in {time.perf_counter() - t0:.2f}"
        f" s; TF32 off for matmuls and cuDNN")
    return cfg, params


def _attention_layers(cfg) -> int:
    """Flash launches a prefill past ATTN_CHUNK_THRESHOLD makes: one a
    layer of the attention families, one a shared-attention site of a
    hybrid, none for the ssm family."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    return cfg.n_layers


def _timed_prefill(prefill, params, toks, cfg):
    """One prefill, timed on the host clock around a synchronise; raises
    unless it launched the tensor-core flash kernel once an attention
    layer (``_attention_layers``) and gave finite (B, vocab) logits.  ->
    (logits, seconds, peak device memory in bytes)."""
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
    want = _attention_layers(cfg)
    if not launches == ops.LAUNCHES["flash_attention"] == want:
        raise AssertionError(f"prefill launched flash_attention "
                             f"{ops.LAUNCHES['flash_attention']} times, "
                             f"{launches} of them the tensor-core kernel, "
                             f"not once per attention layer ({want}) on the "
                             f"tensor cores")
    B, S = toks.shape
    if tuple(logits.shape) != (B, cfg.vocab_size):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill {cfg.arch}: logits not finite")
    peak = torch.cuda.max_memory_allocated()
    log(f"prefill {cfg.arch}: B={B} S={S:,} in {dt:.3f} s = "
        f"{B * S / dt:,.0f} tokens/s; flash_attention launches "
        f"{launches}, all on the tensor cores; peak device memory "
        f"{(peak - held) / 1e9:.3f} GB above the {held / 1e9:.3f} GB held "
        f"before it")
    return logits, dt, peak


def _logits_check(prefill, params, toks, logits, tol, faults_fail=True):
    """The last-token ``logits`` of a kernel prefill on ``toks`` against a
    prefill on the kernel's plain version, and the prefills with planted
    faults against the same: the readings first, then the checks (sound
    within ``tol`` with the same argmax; with ``faults_fail``, every fault
    beyond it).  -> (the plain prefill's layer-0 flash inputs, the sound
    reading, {fault: reading})."""
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
    if passed and faults_fail:
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
    from repro_torch.kernels import ops
    from repro_torch.models import lm, transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params = _draw_params(LM_ARCH)
    rng = np.random.default_rng(13)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        LM_BATCH, LM_SEQ))).cuda()
    prefill = lm.make_prefill_step(cfg)
    # warm-up at the full length, keeping the kernel's layer-0 inputs
    kernel = ops.flash_attention
    with FlashInputs(lambda q, k, v, c, qc, kc: kernel(
            q, k, v, causal=c, q_chunk=qc, kv_chunk=kc)) as kept:
        prefill(params, {"tokens": toks})
    _, dt, _ = _timed_prefill(prefill, params, toks, cfg)
    profile = _profile_prefill(prefill, params, toks)
    row = _layer0(kept.first, "the SmolLM-135M prefill")
    del kept
    # the logits against the plain version's and the planted faults' at
    # FLASH_LM_SEQ, as phase 10 checks them (at LM_SEQ the plain prefill
    # and the two faulted ones took 39 s)
    short = toks[:, :FLASH_LM_SEQ]
    logits, _, _ = _timed_prefill(prefill, params, short, cfg)
    _logits_check(prefill, params, short, logits, LOGITS_TOL)

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
    _, dt, _ = _timed_prefill(prefill, params, toks, cfg)
    profile = _profile_prefill(prefill, params, toks)
    row = _layer0(kept.first, "the StableLM-3B prefill")
    del kept
    short = toks[:, :STABLELM_CHECK_SEQ]
    logits, _, _ = _timed_prefill(prefill, params, short, cfg)
    _logits_check(prefill, params, short, logits, LOGITS_TOL)
    return dict(name="flash_attention_hd80", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
                replaces="src/repro/kernels/flash_attention.py:84",
                launches=cfg.n_layers, **row,
                prefill_tokens_per_s=LM_BATCH * LM_SEQ / dt,
                prefill_profile=profile, hd80_s4096=timing["hd80"])


class MoeDrops:
    """Counts, inside it, the (token, k) pairs ``layers._route`` routes and
    those it drops past their expert's capacity (one device sum a call, read
    at the end)."""

    def __enter__(self):
        from repro_torch.models import layers
        self._saved, self.dropped, self.pairs = layers._route, [], 0

        def wrapped(logits, n_experts, top_k, cap):
            out = self._saved(logits, n_experts, top_k, cap)
            self.dropped.append((~out[4]).sum())
            self.pairs += out[4].numel()
            return out
        layers._route = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers._route = self._saved

    def count(self) -> int:
        import torch
        return int(torch.stack(self.dropped).sum()) if self.dropped else 0


class FullCapacity:
    """Inside it the MoE's prefill capacity is the decode's (E/K), so that
    neither drops a token and decode can be held against forward."""

    def __enter__(self):
        from repro_torch.models import layers
        self._saved = layers.moe
        layers.moe = lambda x, p, cfg, capacity_factor=1.25, **kw: \
            self._saved(x, p, cfg, cfg.n_experts / cfg.top_k, **kw)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers.moe = self._saved


def _decode_against_forward(cfg, params, toks):
    """Decode step by step over the first FAMILY_DEC_SEQ tokens against the
    forward's last logits (at full capacity: ``FullCapacity``), within
    FAMILY_DECODE_TOL.  -> (share of the largest |logit|, decode tokens/s
    of that loop)."""
    import torch
    from repro_torch.models import lm, transformer
    short = toks[:1, :FAMILY_DEC_SEQ]
    with FullCapacity():
        full, _ = transformer.forward(params, {"tokens": short}, cfg)
    serve = lm.make_serve_step(cfg)
    cache = transformer.init_cache(cfg, 1, FAMILY_DEC_SEQ)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(FAMILY_DEC_SEQ):
        lg, cache = serve(params, cache, short[:, t : t + 1], t)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rel = _logits_close(f"{cfg.arch}: decode against forward at "
                        f"S={FAMILY_DEC_SEQ} ({dt:.3f} s, "
                        f"{FAMILY_DEC_SEQ / dt:.1f} tokens/s at batch 1)", lg,
                        full[:, -1], FAMILY_DECODE_TOL)
    return rel, FAMILY_DEC_SEQ / dt


def _generate(cfg, params, rng):
    """``greedy_generate`` at batch FAMILY_GEN_BATCH, timed.  -> new
    tokens/s."""
    import torch
    from repro_torch.models import lm
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        FAMILY_GEN_BATCH, FAMILY_GEN_PROMPT))).cuda()
    lm.greedy_generate(params, cfg, prompt[:, :2], 1)            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = lm.greedy_generate(params, cfg, prompt, FAMILY_GEN_NEW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if tuple(out.shape) != (FAMILY_GEN_BATCH, FAMILY_GEN_PROMPT
                            + FAMILY_GEN_NEW) or not bool(
            (out[:, :FAMILY_GEN_PROMPT] == prompt).all()) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.arch}: greedy_generate gave bad tokens "
                             f"{tuple(out.shape)}")
    steps = FAMILY_GEN_PROMPT + FAMILY_GEN_NEW - 1
    log(f"{cfg.arch}: greedy_generate B={FAMILY_GEN_BATCH}, "
        f"{FAMILY_GEN_PROMPT} + {FAMILY_GEN_NEW} tokens in {dt:.3f} s = "
        f"{FAMILY_GEN_BATCH * FAMILY_GEN_NEW / dt:,.1f} new tokens/s, "
        f"{steps / dt:.1f} decode steps/s")
    return FAMILY_GEN_BATCH * FAMILY_GEN_NEW / dt


def _family(arch, seed, profile=False):
    """One family's model at full width, drawn on the card in bf16 and
    freed on return: a warm-up prefill at FAMILY_SEQ through
    ``transformer.forward`` (its aux, the MoE's drops, the first flash
    call's q, k, v), the timed prefill (launches once an attention layer)
    and, with ``profile``, its profile (reading a trace of 30,000-50,000
    device ops takes 16-24 s); the logits at FAMILY_CHECK_SEQ against the
    plain version's and the planted faults' (models with attention);
    decode against forward; generation.  -> (numbers, the first flash
    call's inputs or None)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm, transformer

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"device memory held before {arch}: {held / 1e9:.3f} GB")
    cfg, params = _draw_params(arch, cast=True)
    weights = torch.cuda.memory_allocated() - held
    rng = np.random.default_rng(seed)
    S = FAMILY_SEQ[arch]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        LM_BATCH, S))).cuda()
    kernel = ops.flash_attention
    t0 = time.perf_counter()
    with FlashInputs(lambda q, k, v, c, qc, kc: kernel(
            q, k, v, causal=c, q_chunk=qc, kv_chunk=kc)) as kept, \
            MoeDrops() as drops:
        warm, aux = transformer.forward(params, {"tokens": toks}, cfg,
                                        last_only=True)
        torch.cuda.synchronize()
    dt_w = time.perf_counter() - t0
    aux = float(aux)
    if not (math.isfinite(aux) and bool(torch.isfinite(warm).all())):
        raise AssertionError(f"{arch}: warm-up prefill not finite (aux {aux})")
    if (aux > 0) != (cfg.family == "moe"):
        raise AssertionError(f"{arch}: aux {aux} for family {cfg.family}")
    n_drop = drops.count()
    moe = (f"; MoE aux {aux:.6g}; (token, expert) pairs dropped past "
           f"capacity {n_drop:,} of {drops.pairs:,} "
           f"({n_drop / drops.pairs:.4%})" if drops.pairs else "")
    log(f"{arch}: warm-up prefill at S={S:,} in {dt_w:.3f} s{moe}")
    prefill = lm.make_prefill_step(cfg)
    logits, dt, peak = _timed_prefill(prefill, params, toks, cfg)
    rel, _ = _logits_diff("prefill logits", logits, warm[:, -1])
    log(f"{arch}: the timed prefill's logits against the warm-up's: max "
        f"|diff| / max |logit| = {rel:.4g}")
    prof = _profile_prefill(prefill, params, toks) if profile else None
    del warm, logits
    out = dict(arch=arch, seq=S, weights_gb=weights / 1e9,
               prefill_s=dt, prefill_tokens_per_s=LM_BATCH * S / dt,
               prefill_peak_gb=peak / 1e9, prefill_profile=prof,
               aux=aux, moe_dropped_pairs=n_drop, moe_pairs=drops.pairs,
               flash_launches=_attention_layers(cfg))
    if _attention_layers(cfg):
        short = toks[:, :FAMILY_CHECK_SEQ]
        lg, _, _ = _timed_prefill(prefill, params, short, cfg)
        # a hybrid attends at 9 of its 63 blocks: a fault there may move
        # the logits less than the tolerance (printed only); the kernel is
        # held to its plain version on the first site's inputs instead
        _, rel, faults = _logits_check(prefill, params, short, lg,
                                       LOGITS_TOL, cfg.family != "hybrid")
        out.update(logits_rel=rel, logits_faults=faults)
    out["decode_rel"], out["decode_tokens_per_s"] = _decode_against_forward(
        cfg, params, toks)
    out["generate_tokens_per_s"] = _generate(cfg, params, rng)
    first = kept.first
    del params, kept
    return out, first


def _low_th_and_cost(idx):
    """Phase 4's index split at LOW_TH (paper Sec. V-A), and the paper's
    cost model (``core.costmodel``) on it: the full-system simulation with
    a read load proportional to each minimizer's PLs (128 reads'
    worth x 1,000), its Eq. 6 DP-memory time, and the paper's system
    estimate.  -> the numbers."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core.index import low_th_split, minimizer_frequencies
    t0 = time.perf_counter()
    split = low_th_split(idx, LOW_TH)
    freqs = minimizer_frequencies(idx)
    read_load = freqs * 128.0 / max(freqs.sum(), 1)
    k_l, k_a, j_l, j_a = cm.full_system_simulation(read_load * 1000, freqs)
    t_dp = (k_l * cm.linear_wf_cycles()["total_cycles"]
            + k_a * cm.affine_wf_cycles()["total_cycles"]) * cm.T_CLK
    est = cm.dart_pim_system()
    speed = cm.speedup_table()
    dt = time.perf_counter() - t0
    log(f"lowTh={LOW_TH} split of phase 4's index: "
        f"{split['n_rare_minimizers']:,} of {split['n_minimizers']:,} "
        f"minimizers rare ({split['rare_minimizer_fraction']:.4f}), "
        f"{split['rare_pl_fraction']:.4f} of the PLs (paper: 0.16% of affine "
        f"instances on RISC-V)")
    log(f"cost model on it: K_L={k_l:.4g} K_A={k_a:.4g} J_L={j_l:.4g} "
        f"J_A={j_a:.4g}, Eq. 6 DP-memory time {t_dp:.4f} s; the paper's "
        f"system at 25k reads a crossbar: {est.exec_time_s:.2f} s, "
        f"{est.throughput_reads_s:,.0f} reads/s, {est.energy_J / 1e3:.2f} kJ"
        f", speedup {speed['minimap2']['speedup']:.1f}x minimap2, "
        f"{speed['parabricks']['speedup']:.2f}x Parabricks ({dt * 1e3:.1f} "
        f"ms of host work)")
    if not 0 < split["n_rare_minimizers"] <= split["n_minimizers"]:
        raise AssertionError(f"lowTh split: {split['n_rare_minimizers']} of "
                             f"{split['n_minimizers']}")
    return dict(n_rare=split["n_rare_minimizers"],
                n_minimizers=split["n_minimizers"],
                rare_minimizer_fraction=split["rare_minimizer_fraction"],
                rare_pl_fraction=split["rare_pl_fraction"], K_L=k_l, K_A=k_a,
                J_L=j_l, J_A=j_a, eq6_dp_memory_s=t_dp, host_ms=dt * 1e3)


def phase_families(idx):
    """Phase 14: the moe, ssm and hybrid families at full width, each drawn
    on the card from seed 0 in bf16 and freed before the next
    (``_family``): Moonlight-16B-A3B (the kernel's hd=128 instance once a
    layer; its layer-0 q, k, v against the plain version and the planted
    faults, timed beside ``scaled_dot_product_attention``), Zamba2-2.7B
    (hd=80 at its 9 shared-attention sites; the first site's q, k, v
    against the plain version), Falcon-Mamba-7B (no attention); then the
    lowTh split of phase 4's index and the cost model on it.  -> (the
    hd=128 kernel's JSON row, the Zamba2 launches, {arch: numbers})."""
    import torch
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nums = {}
    nums[MOE_ARCH], first = _family(MOE_ARCH, 19, profile=True)
    row = _layer0(first, "the Moonlight-16B-A3B prefill")
    del first
    nums[HYBRID_ARCH], first = _family(HYBRID_ARCH, 23)
    q, k, v, causal, qc, kc = first

    def site():
        return ops.flash_attention(q, k, v, causal=causal, q_chunk=qc,
                                   kv_chunk=kc)
    err, share = _flash_close("flash_attention on Zamba2-2.7B's first site",
                              site(), _flash_plain(*first))
    ms = cuda_ms(site, 5, 1)
    hyb = nums[HYBRID_ARCH]
    kernel_share = hyb["flash_launches"] * ms / (hyb["prefill_s"] * 1e3)
    log(f"flash_attention, the first shared-attention site of the Zamba2-2.7B"
        f" prefill: q {tuple(q.shape)}: max |diff| against the plain "
        f"version {err:.3g}, {share:.3g} x the tolerance; {ms:.4f} ms/call, "
        f"x {hyb['flash_launches']} sites = {kernel_share:.2%} of the timed "
        f"prefill's wall time")
    hyb.update(site0_max_abs_err=err, site0_share=share, site_ms=ms,
               kernel_share_of_wall=kernel_share)
    del first, q, k, v
    nums[SSM_ARCH], first = _family(SSM_ARCH, 29)
    if first is not None:
        raise AssertionError("Falcon-Mamba-7B called flash_attention")
    nums["lowth_cost"] = _low_th_and_cost(idx)
    moe = nums[MOE_ARCH]
    hd128 = dict(name="flash_attention_hd128", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
                 replaces="src/repro/kernels/flash_attention.py:84",
                 launches=moe["flash_launches"], **row,
                 prefill_tokens_per_s=moe["prefill_tokens_per_s"],
                 prefill_profile=moe["prefill_profile"],
                 moe_dropped_pairs=moe["moe_dropped_pairs"])
    return hd128, nums[HYBRID_ARCH]["flash_launches"], nums


class StepMarks:
    """Inside it, the train step's attention route (``layers._sdpa_chunked``
    with gradients on) and the optimizer's update are bracketed on the
    stream by CUDA events: every forward run of the attention (the first
    and the remat recomputes through the layer), every backward (from its
    output's gradient to q, k and v's, the query chunks' recompute
    inside), every update.  ``ms()`` sums each kind's windows once the
    stream has run them."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.windows = {"attention forward": [], "attention backward": [],
                        "optimizer": []}
        self._open = []

    @staticmethod
    def _event():
        import torch
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(self) -> dict:
        return {kind: sum(a.elapsed_time(b) for a, b in pairs)
                for kind, pairs in self.windows.items()}

    def __enter__(self):
        import torch
        from repro_torch.models import layers
        from repro_torch.train.optimizer import Optimizer
        marks = self

        class Closes(torch.autograd.Function):
            """Identity on q, k, v; its backward runs after attention's."""
            @staticmethod
            def forward(ctx, q, k, v):
                return q.clone(), k.clone(), v.clone()

            @staticmethod
            def backward(ctx, gq, gk, gv):
                marks.windows["attention backward"].append(
                    (marks._open.pop(), marks._event()))
                return gq, gk, gv

        class Opens(torch.autograd.Function):
            """Identity on the output; its backward runs before attention's."""
            @staticmethod
            def forward(ctx, o):
                return o.clone()

            @staticmethod
            def backward(ctx, g):
                marks._open.append(marks._event())
                return g

        self._attn = saved = layers._sdpa_chunked

        def wrapped(q, k, v, causal, q_chunk=1024, kv_chunk=1024, **kw):
            if not (torch.is_grad_enabled() and q.requires_grad):
                return saved(q, k, v, causal, q_chunk, kv_chunk, **kw)
            q, k, v = Closes.apply(q, k, v)
            start = marks._event()
            try:
                o = saved(q, k, v, causal, q_chunk, kv_chunk, **kw)
            finally:
                # a remat recompute may stop part way (early stop)
                marks.windows["attention forward"].append(
                    (start, marks._event()))
            return Opens.apply(o)
        layers._sdpa_chunked = wrapped
        opt = self.optimizer

        def update(*args):
            start = marks._event()
            out = opt.update(*args)
            marks.windows["optimizer"].append((start, marks._event()))
            return out
        self.marked = Optimizer(init=opt.init, update=update,
                                global_norm=opt.global_norm)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers._sdpa_chunked = self._attn


def _device_ops(prof):
    """(start ns, duration ns, name) of every device activity (kernels,
    copies, fills) of a finished ``torch.profiler`` trace, read from its
    raw events: building ``key_averages`` from a trace of tens of
    thousands of ops takes tens of seconds."""
    from torch.autograd import DeviceType
    return [(e.start_ns(), e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def _step_split(prof, marks):
    """The device time of a profiled train step: the kernels' total and the
    GEMMs' among them (``GEMM_KERNEL_WORDS``; the rest is the elementwise
    chain: casts, norms, RoPE, SiLU, softmax and exponentials, the loss,
    the residual adds, the gradients' widening and sums), read from the
    trace's raw events, and the ``StepMarks`` windows (attention forward
    runs and backward, the optimizer: GEMMs and elementwise both) from
    their CUDA events.  -> {kind: ms}, "kernels" the count."""
    ops_ = _device_ops(prof)
    total = sum(ns for _, ns, _ in ops_) / 1e6
    gemm = sum(ns for _, ns, name in ops_
               if any(w in name.lower() for w in GEMM_KERNEL_WORDS)) / 1e6
    split = {"device": total, "GEMMs": gemm, "elementwise chain":
             total - gemm, "kernels": len(ops_)}
    split.update(marks.ms())
    split["outside the windows"] = total - sum(marks.ms().values())
    return split


def _eval_on(eval_step, params, batch):
    """The eval loss of ``batch`` taken a microbatch at a time (rows m::M,
    as the train step splits it; the mean of equal-sized microbatches' means
    is the batch's), the launch counts set to 0 before each call and read
    after it.  -> (loss, each call's flash_attention_wgmma launches)."""
    from repro_torch.kernels import ops
    total, launches = 0.0, []
    for m in range(TRAIN_MICRO):
        ops.reset_launch_counts()
        out = eval_step(params, {k: v[m::TRAIN_MICRO]
                                 for k, v in batch.items()})
        total += float(out["loss"])
        launches.append(ops.LAUNCHES["flash_attention_wgmma"])
    return total / TRAIN_MICRO, launches


def _eval_layer0(first):
    """The flash kernel on the eval step's layer-0 q, k, v (its first
    microbatch) against its plain version and the planted faults, as
    ``_layer0`` holds a prefill's.  -> the readings."""
    import torch
    from repro_torch.kernels import ops
    q, k, v, causal, qc, kc = first
    got = ops.flash_attention(q, k, v, causal=causal, q_chunk=qc,
                              kv_chunk=kc)
    torch.cuda.synchronize()
    want = _flash_plain(q, k, v, causal, qc, kc)
    what = "layer 0 of the eval step"
    err, share = _flash_close(f"flash_attention on {what}", got, want)
    log(f"flash_attention, {what}: q {tuple(q.shape)} {q.dtype}, causal "
        f"{causal}: max |diff| against the plain version {err:.3g}, "
        f"{share:.3g} x the tolerance")
    t0 = time.perf_counter()
    _check_faults(what, q, k, v, causal, qc, kc, want)
    log(f"planted faults, {what}: {time.perf_counter() - t0:.2f} s")
    return dict(max_abs_err=err, tolerance_share=share, shape=list(q.shape))


def _grad_diff(ref, got):
    """``got``'s (loss, grads) against ``ref``'s: the relative |diff| of
    the loss and of the global grad norm, and the largest ||got - ref|| /
    ||ref|| over the gradient's leaves."""
    from repro_torch.core.tree import leaves
    from repro_torch.train.optimizer import global_norm
    (l0, g0), (l1, g1) = ref, got
    n0, n1 = float(global_norm(g0)), float(global_norm(g1))
    leaf = max(float((b.cpu() - a.cpu()).norm() / a.cpu().norm().clamp_min(
        1e-30)) for a, b in zip(leaves(g0), leaves(g1)))
    return {"loss": abs(float(l1) - float(l0)) / abs(float(l0)),
            "grad_norm": abs(n1 - n0) / n0, "leaf": leaf}


def _beyond(diff):
    """The readings of ``_grad_diff`` beyond their TRAIN_CPU_TOL."""
    return [k for k, r in diff.items() if r > TRAIN_CPU_TOL[k]]


def _reduced_step_cpu_vs_card():
    """One reduced() train step (a row, S past the chunk threshold) on the
    card and through the port on the CPU, on the same weights and batch:
    the step's loss and grad norm, and its gradient leaf by leaf
    (``lm.make_grads_fn``, the step's own gradient), within TRAIN_CPU_TOL;
    then two planted faults on the card (labels shifted by one, layer 0's
    gradient zeroed), each of which must fail them.  -> the sound readings
    and the faults'."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import tree_map
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.models import lm, transformer
    from repro_torch.train.optimizer import adamw
    cfg = reduced(get_config(TRAIN_ARCH))
    params = transformer.as_tree(transformer.init_params(
        cfg, torch.Generator().manual_seed(0)))
    toks, labels = batch_for_step(0, global_batch=1, seq_len=TRAIN_CPU_SEQ,
                                  vocab_size=cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    opt = adamw(warmup=0, total_steps=10)
    grads_of = lm.make_grads_fn(cfg)
    step, grads = {}, {}
    t0 = time.perf_counter()
    # four threads: a CPU step of these small tensors takes minutes with
    # every core's thread contending
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    try:
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            on = {k: v.to(dev) for k, v in batch.items()}
            state = (p, opt.init(p), torch.zeros((), dtype=torch.int32,
                                                 device=dev))
            _, m = lm.make_train_step(cfg, opt, device=dev)(state, on)
            step[dev] = {k: float(v) for k, v in m.items()}
            loss, _, g = grads_of(p, on)
            grads[dev] = (loss, g)
        # the planted faults, on the card
        p = tree_map(lambda t: t.cuda(), params)
        shifted = {"tokens": batch["tokens"].cuda(),
                   "labels": batch["labels"].roll(1, dims=1).cuda()}
        loss, _, g = grads_of(p, shifted)
        faults = {"labels shifted by one": (loss, g)}
        loss, g = grads["cuda"]
        faults["layer 0's gradient zeroed"] = (loss, dict(g, blocks=tree_map(
            lambda t: torch.cat([torch.zeros_like(t[:1]), t[1:]]),
            g["blocks"])))
    finally:
        torch.set_num_threads(threads)
    rel = {k: abs(step["cuda"][k] - step["cpu"][k]) / abs(step["cpu"][k])
           for k in ("loss", "grad_norm")}
    rel["leaf"] = _grad_diff(grads["cpu"], grads["cuda"])["leaf"]
    read = {name: _grad_diff(grads["cpu"], f) for name, f in faults.items()}
    log(f"reduced {cfg.arch} train step at S={TRAIN_CPU_SEQ:,}, card "
        f"against CPU: loss {step['cuda']['loss']:.6f} / "
        f"{step['cpu']['loss']:.6f}, grad norm {step['cuda']['grad_norm']:.6f}"
        f" / {step['cpu']['grad_norm']:.6f}; relative {rel['loss']:.3g} and "
        f"{rel['grad_norm']:.3g}, the largest leaf's relative gradient "
        f"|diff| {rel['leaf']:.3g} (tolerances {TRAIN_CPU_TOL}); "
        f"{time.perf_counter() - t0:.2f} s")
    log("planted faults, the reduced train step on the card: " + "; ".join(
        f"{name}: loss {r['loss']:.3g}, grad norm {r['grad_norm']:.3g}, "
        f"leaf {r['leaf']:.3g}" for name, r in read.items()))
    if _beyond(rel):
        raise AssertionError(f"reduced train step: card and CPU disagree "
                             f"({_beyond(rel)})")
    passed = [name for name, r in read.items() if not _beyond(r)]
    if passed:
        raise AssertionError(f"planted faults pass the card-against-CPU "
                             f"check: {passed}")
    return dict(rel, faults=read)


def phase_train(work):
    """Phase 15, LM training: SmolLM-135M at full width through the
    ``Trainer`` (see the module docstring).  -> the phase's numbers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"device memory held before the training phase: {held / 1e9:.3f} "
        f"GB")
    cfg = get_config(TRAIN_ARCH)
    steps = 1 + TRAIN_TIMED
    opt = adamw(lr=TRAIN_LR, warmup=min(20, steps // 10), total_steps=steps)
    ckpt = os.path.join(work, "train_ckpt")
    tcfg = TrainerConfig(total_steps=steps, global_batch=TRAIN_BATCH,
                         seq_len=TRAIN_SEQ, ckpt_dir=ckpt,
                         ckpt_every=TRAIN_CKPT_EVERY, log_every=1, seed=0)
    # the embedding's backward accumulates rows by atomics unless asked not
    # to: deterministic algorithms make a replay bit for bit
    # (the NaN fill of new tensors that comes with them is left off: it is
    # a check for reads of uninitialised memory, and would add a write to
    # every allocation of the timed steps)
    was = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        step_fn = lm.make_train_step(cfg, opt, num_microbatches=TRAIN_MICRO)
        trainer = Trainer(cfg, tcfg, optimizer=opt, train_step_fn=step_fn)
        t0 = time.perf_counter()
        state0 = trainer.init_state()
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in leaves(state0[0]))
        log(f"train: {_describe(cfg)}, remat {cfg.remat}: {n_params:,} "
            f"float32 parameters and adamw's m, v drawn on the card from "
            f"seed 0 in {time.perf_counter() - t0:.2f} s; global batch "
            f"{TRAIN_BATCH} x S={TRAIN_SEQ:,} in {TRAIN_MICRO} microbatches;"
            f" deterministic algorithms on")
        eval_step = lm.make_eval_step(cfg)
        batch0 = trainer.batch_for(0)
        # the eval step through the kernel, keeping its layer-0 inputs
        kernel = ops.flash_attention
        t0 = time.perf_counter()
        with FlashInputs(lambda q, k, v, c, qc, kc: kernel(
                q, k, v, causal=c, q_chunk=qc, kv_chunk=kc)) as kept:
            before, per_call = _eval_on(eval_step, state0[0], batch0)
        dt_eval = time.perf_counter() - t0
        if per_call != [cfg.n_layers] * TRAIN_MICRO:
            raise AssertionError(f"eval step: flash_attention_wgmma "
                                 f"launches {per_call}, not {cfg.n_layers} "
                                 f"a call")
        eval_layer0 = _eval_layer0(kept.first)
        del kept
        t0 = time.perf_counter()
        with FlashInputs(FLASH_FAULTS["a kv tile skipped"]):
            faulted, _ = _eval_on(eval_step, state0[0], batch0)
        log(f"eval with a kv tile skipped: {time.perf_counter() - t0:.2f} s")

        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        final = trainer.run(state0)
        dt_run = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        train_launches = ops.LAUNCHES["flash_attention_wgmma"]
        log_ = trainer.metrics_log
        for rec in log_:
            log(f"train step {rec['step']}: loss {rec['loss']:.6f}, grad "
                f"norm {rec['grad_norm']:.6f}, {rec['step_time_s']:.3f} s")
        if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                   for r in log_) or len(log_) != steps:
            raise AssertionError("train: a step's loss or grad norm is not "
                                 "finite, or a step is missing")
        if train_launches:
            raise AssertionError(f"train steps launched the flash kernel "
                                 f"{train_launches} times")
        timed = [r["step_time_s"] for r in log_[1:]]
        tok_s = TRAIN_BATCH * TRAIN_SEQ / (sum(timed) / len(timed))
        log(f"train: {steps} steps in {dt_run:.2f} s (checkpoints "
            f"included); the {TRAIN_TIMED} after the warm-up "
            f"{min(timed):.3f}-{max(timed):.3f} s = {tok_s:,.0f} training "
            f"tokens/s; peak device memory {(peak - held) / 1e9:.3f} GB "
            f"above the {held / 1e9:.3f} GB held before; flash launches in "
            f"the train steps: {train_launches}")

        diff = abs(log_[0]["loss"] - before)
        fault_diff = abs(faulted - before)
        log(f"train step 0's loss {log_[0]['loss']:.6f} (the gradient "
            f"route, _sdpa_chunked) against the eval step's {before:.6f} "
            f"(flash_attention_wgmma, {per_call} launches a call; "
            f"{dt_eval:.3f} s for the four): |diff| {diff:.4g} (tolerance "
            f"{TRAIN_EVAL_TOL}); with a kv tile skipped {faulted:.6f}, "
            f"|diff| {fault_diff:.4g}")
        if diff > TRAIN_EVAL_TOL:
            raise AssertionError("train and eval losses disagree")
        if fault_diff <= TRAIN_EVAL_TOL:
            raise AssertionError("a skipped kv tile passes the train/eval "
                                 "loss check")
        after, _ = _eval_on(eval_step, final[0], batch0)
        log(f"eval loss on step 0's batch: {before:.6f} before the steps, "
            f"{after:.6f} after")
        if not after < before:
            raise AssertionError("training did not lower the eval loss")

        # restart: the unbroken run's last checkpoint removed, as if it had
        # died after step 3's; a new Trainer on its directory restores that
        # checkpoint and replays step 4 to the unbroken run's state
        shutil.rmtree(os.path.join(ckpt, f"step_{steps:012d}"))
        if ckpt_lib.all_steps(ckpt) != [TRAIN_CKPT_EVERY]:
            raise AssertionError(f"checkpoints {ckpt_lib.all_steps(ckpt)}")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        replay = Trainer(cfg, TrainerConfig(
            total_steps=steps, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            ckpt_dir=ckpt, ckpt_every=0, log_every=1, seed=0),
            optimizer=opt, train_step_fn=step_fn)
        restored = replay.run()
        dt_replay = time.perf_counter() - t0
        same = [bool(torch.equal(a, b)) for a, b in zip(leaves(final),
                                                        leaves(restored))]
        worst = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(leaves(final), leaves(restored)))
        log(f"restart from the checkpoint after step "
            f"{TRAIN_CKPT_EVERY - 1}: steps "
            f"{[r['step'] for r in replay.metrics_log]} replayed in "
            f"{dt_replay:.2f} s; {sum(same)} of {len(same)} state leaves "
            f"bit for bit the unbroken run's (max |diff| {worst:.3g}); flash"
            f" launches {ops.LAUNCHES['flash_attention_wgmma']}")
        if [r["step"] for r in replay.metrics_log] != list(
                range(TRAIN_CKPT_EVERY, steps)) or not all(same):
            raise AssertionError("the restarted run did not replay the "
                                 "unbroken run's last steps to its state")
        del restored, replay
        shutil.rmtree(ckpt)             # 1.6 GB a checkpoint

        # the step's device split, over one step of one microbatch
        t_prof = time.perf_counter()
        with StepMarks(opt) as marks:
            one = lm.make_train_step(cfg, marks.marked)
            mb = {k: v[::TRAIN_MICRO] for k, v in batch0.items()}
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                one(final, mb)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            split = _step_split(prof, marks)
            del prof
        log(f"train step profile (one microbatch of {TRAIN_BATCH // TRAIN_MICRO}"
            f" rows, the optimizer once; the trace read in "
            f"{time.perf_counter() - t0:.2f} s): {wall:.3f} s wall under the"
            f" profiler, device time {split['device']:.3f} ms "
            f"({split['device'] / 1e3 / wall:.2%} of the wall) over "
            f"{split['kernels']:,} device ops; by kernel: " + ", ".join(
                f"{k} {split[k]:.3f} ms = {split[k] / split['device']:.2%}"
                for k in ("GEMMs", "elementwise chain")) + "; by window "
            f"({len(marks.windows['attention forward'])} attention forward "
            f"runs, {len(marks.windows['attention backward'])} backward): "
            + ", ".join(f"{k} {split[k]:.3f} ms = "
                        f"{split[k] / split['device']:.2%}"
                        for k in ("attention forward", "attention backward",
                                  "optimizer", "outside the windows")))
        log(f"train step profile: {time.perf_counter() - t_prof:.2f} s "
            f"in all")
        mb_ms = split["device"] - split["optimizer"]
        full = TRAIN_MICRO * mb_ms + split["optimizer"]
        log(f"train step profile, scaled to the step of {TRAIN_MICRO} "
            f"microbatches: device {full:.3f} ms; attention backward "
            f"{TRAIN_MICRO * split['attention backward'] / full:.2%}, "
            f"attention forward "
            f"{TRAIN_MICRO * split['attention forward'] / full:.2%}, "
            f"optimizer {split['optimizer'] / full:.2%}")
        rel = _reduced_step_cpu_vs_card()
    finally:
        torch.use_deterministic_algorithms(was)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    del state0, final
    torch.cuda.empty_cache()
    return dict(arch=cfg.arch, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                microbatches=TRAIN_MICRO, tokens_per_s=tok_s,
                step_s=timed, warmup_step_s=log_[0]["step_time_s"],
                peak_gb=(peak - held) / 1e9, eval_before=before,
                eval_after=after, train_eval_diff=diff,
                fault_diff=fault_diff, eval_launches=per_call,
                eval_layer0=eval_layer0,
                train_launches=train_launches, split=split,
                cpu_rel=rel, losses=[r["loss"] for r in log_])


def _roofline_lines(measured):
    """The H100 roofline (``launch.roofline``, one card) of each timed
    prefill and train step: ``measured`` holds (label, arch, kind, batch,
    seq, microbatches, seconds).  -> {label: numbers}."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import roofline as rl
    out = {}
    for label, arch, kind, B, S, n_micro, secs in measured:
        cfg = get_config(arch)
        r = rl.cell_roofline(cfg, ShapeCell(label, S, B, kind),
                             {"data": 1, "model": 1}, n_micro)
        useful_s = r.useful_flops / rl.PEAK_FLOPS
        out[label] = dict(arch=arch, kind=kind, batch=B, seq=S,
                          microbatches=n_micro, measured_s=secs,
                          bound_s=r.bound_s, dominant=r.dominant,
                          compute_s=r.compute_s, memory_s=r.memory_s,
                          roofline_fraction=r.roofline_fraction,
                          bound_share=r.bound_s / secs,
                          useful_share=useful_s / secs)
        log(f"roofline {label} ({arch}, {kind}, B={B} S={S:,}"
            f"{f', {n_micro} microbatches' if n_micro > 1 else ''}): bound "
            f"{r.bound_s * 1e3:.3f} ms ({r.dominant}; compute "
            f"{r.compute_s * 1e3:.3f} ms, memory {r.memory_s * 1e3:.3f} ms),"
            f" roofline_fraction {r.roofline_fraction:.4f} (useful "
            f"{useful_s * 1e3:.3f} ms); measured {secs:.4f} s: the bound is "
            f"{r.bound_s / secs:.4%} of it, the useful FLOPs at peak "
            f"{useful_s / secs:.4%}")
    return out


def _one_rank_mesh():
    """A one-rank NCCL group on the card and its 1x1 ("data", "model")
    device mesh."""
    import socket

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    return make_mesh((1, 1), ("data", "model"), "cuda")


def _mesh_train(mesh):
    """SmolLM-135M at full width on the 1x1 mesh: one sharded train step
    (parameters and adamw state DTensors placed by ``param_specs``)
    against the plain step on the same weights and batch, then a sharded
    prefill at MESH_PREFILL_SEQ whose flash calls run through
    ``local_map`` on head-sharded q, k, v (counted) against the plain
    prefill's logits.  -> numbers."""
    import dataclasses

    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import distribute
    from repro_torch.models import lm, transformer
    from repro_torch.models.layers import Shardings
    from repro_torch.train.optimizer import adamw

    cfg, params = _draw_params(LM_ARCH)
    params = transformer.as_tree(params)
    sh = Shardings(batch=("data",), model=("model",), fsdp=("data",),
                   model_size=1)
    rng = np.random.default_rng(29)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        MESH_TRAIN_BATCH, MESH_TRAIN_SEQ + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = adamw(lr=TRAIN_LR, warmup=0, total_steps=2)
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    _, want = lm.make_train_step(cfg, opt)((params, opt.init(params), zero),
                                           batch)
    sharded = distribute(params, mesh, transformer.param_specs(cfg, sh))
    step = lm.make_train_step(cfg, opt, sh=sh)
    t0 = time.perf_counter()
    (new, _, _), got = step((sharded, opt.init(sharded), zero), batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rel = {k: abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
           for k in ("loss", "grad_norm")}
    placed = new["blocks"]["attn"]["wq"].placements
    log(f"mesh 1x1 (NCCL, one rank): SmolLM-135M sharded train step, "
        f"{MESH_TRAIN_BATCH} rows of {MESH_TRAIN_SEQ}: loss "
        f"{float(got['loss']):.6f} against the plain step's "
        f"{float(want['loss']):.6f} (relative {rel['loss']:.3g}), grad norm "
        f"{float(got['grad_norm']):.6f} against {float(want['grad_norm']):.6f}"
        f" (relative {rel['grad_norm']:.3g}); {dt:.3f} s with DTensor's first"
        f" sharding propagation; the new wq placed {placed}")
    for k, v in rel.items():
        if not v <= MESH_TRAIN_TOL:
            raise AssertionError(f"mesh train step: {k} {v} relative off the "
                                 f"plain step's (tolerance {MESH_TRAIN_TOL})")
    del new, got, want, step
    pre = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        1, MESH_PREFILL_SEQ)))
    plain = lm.make_prefill_step(cfg)(params, {"tokens": pre})
    # one row: the batch is not split (the reference's dry run's rule)
    prefill = lm.make_prefill_step(cfg, sh=dataclasses.replace(sh, batch=()))
    prefill(sharded, {"tokens": pre})          # DTensor's propagation
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = prefill(sharded, {"tokens": pre})
    torch.cuda.synchronize()
    dt_p = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if launches["flash_attention_wgmma"] != cfg.n_layers:
        raise AssertionError(f"sharded prefill: flash launches {launches}, "
                             f"not one a layer ({cfg.n_layers}) on the "
                             f"tensor cores")
    rel_p, same = _logits_diff("sharded prefill", logits.full_tensor(), plain)
    log(f"mesh 1x1: SmolLM-135M sharded prefill at S={MESH_PREFILL_SEQ:,}: "
        f"{dt_p:.3f} s; flash_attention launches {launches['flash_attention']}"
        f" through local_map, all on the tensor cores; logits against the "
        f"plain prefill's: max |diff| / max |logit| {rel_p:.3g}, same argmax"
        f" {same}")
    if not (rel_p <= LOGITS_TOL and same):
        raise AssertionError(f"sharded prefill logits {rel_p} off the plain "
                             f"prefill's")
    del sharded, params, logits, plain
    torch.cuda.empty_cache()
    return dict(train_rel=rel, train_s=dt, prefill_s=dt_p,
                prefill_launches=launches["flash_attention"])


class DecodeSites:
    """Inside it, each local-form flash-decode call over a whole cache
    (``layers._flash_decode``) is also computed by the unsharded decode's
    attention on the same q and cache (``layers._sdpa``); keeps the
    largest max |diff| / max |unsharded| over the calls."""

    def __enter__(self):
        from repro_torch.models import layers
        self._saved, self.worst, self.calls = layers._flash_decode, 0.0, 0

        def wrapped(q, k, v, pos, shards, first):
            o = self._saved(q, k, v, pos, shards, first)
            want = layers._sdpa(q, k, v, causal=True, q_offset=pos).float()
            self.worst = max(self.worst, float(
                (o.float() - want).abs().max() / want.abs().max()))
            self.calls += 1
            return o
        layers._flash_decode = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers._flash_decode = self._saved


def _drop_shard(n, j):
    """A planted fault in the local form's combine: ``n`` shards with
    shard ``j``'s num and den left out of the sums (its max still
    taken)."""
    import torch
    from repro_torch.models.layers import LocalSeqShards

    class DropShard(LocalSeqShards):
        def sum(self, x):
            keep = torch.ones(self.n, dtype=x.dtype, device=x.device)
            keep[j] = 0
            return (x * keep.view((1, -1) + (1,) * (x.dim() - 2))).sum(
                1, keepdim=True)
    return DropShard(n)


def _profile_decode(step):
    """One decode step (``step()``) under ``torch.profiler``: its wall
    time, the device time of its kernels (one stream, so their sum is the
    device's busy time) and the five largest device ops.  -> numbers, or
    None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for _, ns, name in _device_ops(prof):
        us, k = by_name.get(name, (0.0, 0))
        by_name[name] = (us + ns / 1e3, k + 1)
    total = sum(us for us, _ in by_name.values())
    if not total:
        return None
    top = sorted(((us, k, name) for name, (us, k) in by_name.items()),
                 reverse=True)[:5]
    return dict(wall_ms=wall * 1e3, device_ms=total / 1e3,
                device_share=total / 1e3 / (wall * 1e3),
                ops=sum(k for _, k in by_name.values()),
                top=[(us / 1e3, k, name[:90]) for us, k, name in top])


def _long_decode(mesh):
    """Zamba2-2.7B's long_500k decode at full width and depth (see the
    constants): the local form on LONG_SHARDS sequence shards against the
    unsharded decode on the same cache, a shard dropped from the combine
    (must fail), and the group form on the one-rank mesh against the local
    form of one shard (bit for bit).  Each form starts from the same SSM
    states and cache rows; each one's first step must write row
    LONG_SEQ - MESH_DEC_STEPS of k and v at every site and no row beside
    it, and at site 0, whose inputs all forms share, the very row the
    unsharded decode writes.  One step of the sharded and of the
    unsharded form is profiled (device time against wall time).
    -> numbers."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.core.tree import leaves
    from repro_torch.launch.mesh import named
    from repro_torch.models import lm, transformer
    from repro_torch.models.layers import LocalSeqShards, Shardings

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"device memory held before the long_500k decode: {held / 1e9:.3f} "
        f"GB")
    cfg, params = _draw_params(HYBRID_ARCH, cast=True)
    params = transformer.cast_params(params)
    w_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    t0 = time.perf_counter()
    cache = transformer.init_cache(cfg, 1, LONG_SEQ)
    g = torch.Generator(device="cuda").manual_seed(31)
    cache["attn"]["k"].normal_(0, LONG_K_STD, generator=g)
    cache["attn"]["v"].normal_(0, LONG_V_STD, generator=g)
    for t in cache["ssm"].values():
        t.normal_(0, LONG_STATE_STD, generator=g)
    state0 = {k: t.clone() for k, t in cache["ssm"].items()}
    torch.cuda.synchronize()
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in cache["attn"].values())
    st_bytes = sum(t.numel() * t.element_size() for t in state0.values())
    log(f"long_500k: {_describe(cfg)}; KV cache of {cfg.n_layers // cfg.attn_every}"
        f" sites x {LONG_SEQ:,} positions x {cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}: {kv_bytes / 1e9:.3f} GB, SSM states "
        f"{st_bytes / 1e6:.1f} MB, filled from seed 31 in "
        f"{time.perf_counter() - t0:.2f} s")
    toks = torch.from_numpy(np.random.default_rng(37).integers(
        0, cfg.vocab_size, (1, MESH_DEC_STEPS)))
    p0 = LONG_SEQ - MESH_DEC_STEPS
    # rows p0 - 1 ... of every site as the seed filled them: each run
    # starts from them, and its first step must write row p0 alone
    fill = {n: t[:, :, p0 - 1:].clone() for n, t in cache["attn"].items()}
    profiles = {}

    def run(what, axes, c=cache, profile=False):
        kv = {n: t.to_local() if isinstance(t, DTensor) else t
              for n, t in c["attn"].items()}
        for k, t in cache["ssm"].items():
            t.copy_(state0[k])
        for n, t in kv.items():
            t[:, :, p0 - 1:].copy_(fill[n])
        serve = lm.make_serve_step(cfg, seq_shard_axes=axes)
        out, times = [], []
        for i in range(MESH_DEC_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lg, _ = serve(params, c, toks[:, i:i + 1], p0 + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            out.append(lg.float())
            if i == 0:
                rows = {n: t[:, :, p0 - 1:p0 + 2].clone()
                        for n, t in kv.items()}
        step = sum(times[1:]) / len(times[1:])
        log(f"long_500k decode, {what}: {MESH_DEC_STEPS} tokens at positions "
            f"{p0:,}-{LONG_SEQ - 1:,}; "
            f"{step * 1e3:.2f} ms a step after the first "
            f"({times[0] * 1e3:.2f} ms) = {1 / step:.2f} tokens/s")
        if profile:
            prof = _profile_decode(lambda: serve(params, c, toks[:, 1:2],
                                                 p0 + 1))
            profiles[what] = prof
            if prof is None:
                log(f"long_500k profile, {what}: the trace holds no device "
                    f"time")
            else:
                log(f"long_500k profile, {what}: one step "
                    f"{prof['wall_ms']:.2f} ms wall under the profiler, "
                    f"device time {prof['device_ms']:.2f} ms "
                    f"({prof['device_share']:.2%} of the wall, one stream) "
                    f"over {prof['ops']:,} device ops; the five largest:")
                for ms, k, name in prof["top"]:
                    log(f"  {ms:10.3f} ms {k:6d} x  {name}")
        return torch.stack(out), step, rows

    def written(what, rows, want=None):
        """The first step wrote row p0 of k and v at every site and no row
        beside it; with ``want`` (another form's rows), site 0's row p0,
        whose inputs the forms share, equal to it bit for bit."""
        for n, r in rows.items():
            f = fill[n][:, :, :3]
            if not (torch.equal(r[:, :, 0], f[:, :, 0])
                    and torch.equal(r[:, :, 2], f[:, :, 2])):
                raise AssertionError(f"long_500k, {what}: the first step "
                                     f"wrote {n} beside row {p0:,}")
            if not bool((r[:, :, 1] != f[:, :, 1]).flatten(1).any(1).all()):
                raise AssertionError(f"long_500k, {what}: row {p0:,} of {n} "
                                     f"not written at every site")
            if want is not None and not torch.equal(r[0, :, 1],
                                                    want[n][0, :, 1]):
                off = (r[0, :, 1].float() - want[n][0, :, 1].float()).abs()
                raise AssertionError(
                    f"long_500k, {what}: site 0's row {p0:,} of {n} is "
                    f"{float(off.max())} off the unsharded decode's")

    torch.cuda.reset_peak_memory_stats()
    sharded, t_sh, rows_sh = run(f"local form, {LONG_SHARDS} sequence "
                                 f"shards", LONG_SHARDS, profile=True)
    plain, t_pl, rows_pl = run("unsharded", (), profile=True)
    peak = torch.cuda.max_memory_allocated()
    written("unsharded", rows_pl)
    written(f"local form, {LONG_SHARDS} shards", rows_sh, rows_pl)
    later = max(float((rows_sh[n][1:, :, 1].float()
                       - rows_pl[n][1:, :, 1].float()).abs().max())
                for n in rows_sh)
    log(f"long_500k: the first step's k and v rows at {p0:,}: written at "
        f"every site and nowhere beside; site 0's (the same inputs in both "
        f"forms) equal to the unsharded decode's bit for bit; sites 1-"
        f"{cfg.n_layers // cfg.attn_every - 1} (after site 0's attention) "
        f"max |diff| {later:.4g}")
    with DecodeSites() as sites:
        run(f"local form, {LONG_SHARDS} shards, each site also unsharded",
            LONG_SHARDS)
    log(f"long_500k: at every site of every step ({sites.calls} calls) the "
        f"{LONG_SHARDS}-shard attention output against the unsharded one on"
        f" the same q and cache: max |diff| / max |unsharded| "
        f"{sites.worst:.4g} (tolerance {LONG_ATTN_TOL:.4g})")
    if not sites.worst <= LONG_ATTN_TOL or sites.calls != \
            MESH_DEC_STEPS * (cfg.n_layers // cfg.attn_every):
        raise AssertionError(f"long_500k: the sharded attention is "
                             f"{sites.worst} off the unsharded one "
                             f"({sites.calls} calls)")
    d = float((sharded - plain).abs().max())
    scale = float(plain.abs().max())
    same = bool((sharded.argmax(-1) == plain.argmax(-1)).all())
    bound_bytes = kv_bytes + w_bytes + 2 * st_bytes
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    log(f"long_500k: {LONG_SHARDS}-shard local form against unsharded: max "
        f"|logit diff| {d:.4g} over {MESH_DEC_STEPS} steps (the reference's "
        f"reduced-config bar {LONG_DECODE_TOL}, printed; max |logit| "
        f"{scale:.3f}), same argmax {same}; "
        f"peak device memory {peak / 1e9:.3f} GB; a step reads the KV cache, "
        f"the weights ({w_bytes / 1e9:.3f} GB) and the SSM states (read and "
        f"written): bound {bound_ms:.2f} ms ({kv_bytes / HBM_BYTES_PER_S * 1e3:.2f}"
        f" ms for the cache alone) at 3.35 TB/s; measured "
        f"{t_sh * 1e3:.2f} ms sharded ({bound_ms / (t_sh * 1e3):.2%} of the "
        f"bound's speed), {t_pl * 1e3:.2f} ms unsharded "
        f"({bound_ms / (t_pl * 1e3):.2%})")
    if not bool(torch.isfinite(sharded).all()):
        raise AssertionError("long_500k: the sharded decode's logits are "
                             "not finite")
    with DecodeSites() as bad_sites:
        bad, _, _ = run("planted fault: shard 0's num and den left out",
                     _drop_shard(LONG_SHARDS, 0))
    d_bad = float((bad - plain).abs().max())
    log(f"long_500k: the planted fault reads {bad_sites.worst:.4g} at the "
        f"sites ({bad_sites.worst / LONG_ATTN_TOL:.1f} x the tolerance) and "
        f"{d_bad:.4g} in the logits")
    if not bad_sites.worst > LONG_ATTN_TOL:
        raise AssertionError(f"long_500k: a shard left out of the combine "
                             f"passed ({bad_sites.worst})")
    del bad
    one, _, rows_one = run("local form, one shard", LocalSeqShards(1))
    sh = Shardings(batch=(), model=("model",), fsdp=(), model_size=1)
    where = named(mesh, transformer.cache_specs(cfg, sh,
                                                seq_shard_axes=("data",)))
    group_cache = {"ssm": cache["ssm"], "attn": {
        k: DTensor.from_local(t, mesh, where["attn"][k].placements,
                              run_check=False)
        for k, t in cache["attn"].items()}}
    grp, t_grp, rows_grp = run("group form, a one-rank NCCL group",
                               ("data",), group_cache)
    written("local form, one shard", rows_one, rows_pl)
    written("group form", rows_grp, rows_pl)
    if not torch.equal(grp, one):
        raise AssertionError(f"long_500k: the group form is "
                             f"{float((grp - one).abs().max())} off the local"
                             f" form of one shard")
    log("long_500k: the group form (all_reduce over the data axis's group) "
        "equals the local form of one shard bit for bit; both wrote row "
        f"{p0:,} alone, site 0's equal to the unsharded decode's")
    del cache, group_cache, state0, params, sharded, plain, one, grp
    torch.cuda.empty_cache()
    return dict(seq=LONG_SEQ, shards=LONG_SHARDS, steps=MESH_DEC_STEPS,
                kv_gb=kv_bytes / 1e9, weights_gb=w_bytes / 1e9,
                max_abs_diff=d, fault_diff=d_bad, sites_rel=sites.worst,
                fault_sites_rel=bad_sites.worst, peak_gb=peak / 1e9,
                sharded_ms=t_sh * 1e3, unsharded_ms=t_pl * 1e3,
                group_ms=t_grp * 1e3, bound_ms=bound_ms,
                sharded_tokens_per_s=1 / t_sh,
                unsharded_tokens_per_s=1 / t_pl, later_rows_diff=later,
                profile={k: v and {m: v[m] for m in ("wall_ms", "device_ms",
                                                     "device_share", "ops")}
                         for k, v in profiles.items()})


def phase_production_mesh(measured):
    """Phase 16: the roofline of every timed prefill and train step
    (``measured``, see ``_roofline_lines``), then on a one-rank NCCL group
    and its 1x1 mesh the sharded train step and prefill
    (``_mesh_train``) and Zamba2-2.7B's long_500k decode on the sequence-
    sharded cache (``_long_decode``).  -> numbers."""
    import torch.distributed as dist
    out = {"roofline": _roofline_lines(measured)}
    mesh = _one_rank_mesh()
    try:
        out["train"] = _mesh_train(mesh)
        out["long_500k"] = _long_decode(mesh)
    finally:
        dist.destroy_process_group()
    return out


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
    generated = phase_minimizer_encodings(rs)
    phase_done("6 minimizer scan")
    # phase 7's FASTA and FASTQ serve phase 11 too
    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        mf = phase_map_fastq(ref, rs, work)
        phase_done("7 map_fastq")
        runs["paired"], rescue, pairs = phase_paired(idx, ref)
        phase_done("7b paired-end")
        rows = phase_mainpath_kernels(runs, generated)
        rows["affine_wf_dist"]["rescue"] = rescue
        lead = _leading_deletions(compacted)
        single = type(compacted)(position=compacted.position,
                                 distance=compacted.distance,
                                 mapped=compacted.mapped,
                                 strand=compacted.strand)
        del runs, compacted                 # the kept kernel inputs
        phase_done("8 main-path kernels")
        timing = phase_flash_parity()
        rows["flash_attention"] = phase_lm(timing)
        phase_done("9 LM serving")
        rows["flash_attention_hd80"] = phase_stablelm(timing)
        phase_done("10 StableLM-3B prefill")
        rows["flash_attention_hd128"], zamba_sites, families = \
            phase_families(idx)
        rows["flash_attention_hd80"]["launches_zamba2_prefill"] = zamba_sites
        rows["flash_attention_hd128"]["families"] = families
        phase_done("14 LM families")
        rows["flash_attention"]["train"] = phase_train(work)
        phase_done("15 LM training")
        train = rows["flash_attention"]["train"]
        measured = [
            ("SmolLM-135M prefill", LM_ARCH, "prefill", LM_BATCH, LM_SEQ, 1,
             LM_BATCH * LM_SEQ / rows["flash_attention"][
                 "prefill_tokens_per_s"]),
            ("StableLM-3B prefill", STABLELM_ARCH, "prefill", LM_BATCH,
             LM_SEQ, 1, LM_BATCH * LM_SEQ / rows["flash_attention_hd80"][
                 "prefill_tokens_per_s"]),
            *((f"{arch} prefill", arch, "prefill", LM_BATCH,
               FAMILY_SEQ[arch], 1, families[arch]["prefill_s"])
              for arch in (MOE_ARCH, HYBRID_ARCH, SSM_ARCH)),
            ("SmolLM-135M train step", TRAIN_ARCH, "train", TRAIN_BATCH,
             TRAIN_SEQ, TRAIN_MICRO, sum(train["step_s"]) / len(
                 train["step_s"]))]
        rows["flash_attention"]["mesh"] = phase_production_mesh(measured)
        phase_done("16 production mesh")
        service = phase_service(idx, rs, pairs, mf, work)
        phase_done("12 serving, resilience, observability")
        mesh, mesh_parity = phase_mesh(idx, ref, rs, single, lead, pairs,
                                       mf, work)
        phase_done("13 mesh topology")
        del idx, pairs, single, lead
        sharded = phase_sharded(ref, rs, mf, work)
        phase_done("11 sharded index")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # each mapper kernel's launches on the sharded path, step by step
    for name in MAPPER_KERNELS:
        rows[name]["sharded_launches"] = dict(
            {f"map_fastq --index-dir {e}": l[name]
             for e, l in sharded["map_fastq"].items()},
            evicting=sharded["evicting"][name],
            origin=sharded["origin"][name])
    rows["minimizer_scan"]["sharded_launches"].update(
        build_tiles=sharded["build_tiles"])
    # and on the serving path, engine by engine
    for name in MAPPER_KERNELS:
        rows[name]["service_launches"] = {
            step: l[name] for step, l in service.items()}
    # and on the mesh (phase 13), step by step
    for name in MAPPER_KERNELS:
        rows[name]["mesh_launches"] = {step: l[name]
                                       for step, l in mesh.items()}
        if name in mesh_parity:
            rows[name]["mesh_parity"] = mesh_parity[name]
    log(f"total {time.perf_counter() - t_all:.2f} s")
    log(smi)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
