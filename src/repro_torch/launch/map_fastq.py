"""FASTA + FASTQ -> SAM, end-to-end over the ``Mapper`` session — the
single-topology part of ``repro.launch.map_fastq``.

    PYTHONPATH=src python -m repro_torch.launch.map_fastq ref.fa reads.fq \
        -o out.sam                      # on the CUDA card
    PYTHONPATH=src python -m repro_torch.launch.map_fastq ref.fa reads.fq \
        -o out.sam --device cpu         # kernels' plain versions on the CPU
    PYTHONPATH=src python -m repro_torch.launch.map_fastq ref.fa \
        --r1 reads_R1.fastq.gz --r2 reads_R2.fastq.gz -o out.sam
    PYTHONPATH=src python -m repro_torch.launch.map_fastq ref.fa pairs.fq \
        --interleaved -o out.sam
    PYTHONPATH=src python -m repro_torch.launch.map_fastq --index-dir \
        ref.idx reads.fq -o out.sam --index-budget-mb 512 --prefetch

A (multi-contig) FASTA reference is indexed in memory (or a prebuilt
sharded index is opened, ``--index-dir``: ``launch.build_index`` of
either package; its partitions load into a device arena under
``--index-budget-mb``, staged a chunk ahead with ``--prefetch``), FASTQ
reads stream through the session in ``--chunk-reads`` batches — each chunk
mapped on **both strands** (``--single-strand`` disables) on the
``--engine compacted|fused|padded`` — and spec-valid SAM comes out, line
for line the reference's apart from ``@PG``.  Plain and ``.gz`` FASTQ
parse identically.  Single-end records carry FLAG 0x4/0x10 and MAPQ 255.
Paired-end input (``--r1``/``--r2`` or ``--interleaved``) maps both
mates of every pair in one stacked batch, resolves proper pairs (FR
orientation, insert window from a running median, mate rescue on the
mapper's device — see ``repro_torch.core.pairing``) and emits the full
pairing FLAGs, RNEXT/PNEXT/TLEN and calibrated MAPQ.

The command line is the reference's, with these differences:

* ``--wf-backend`` takes ``cuda|torch`` (default ``cuda``), for the
  index build's minimizer scan and seeding as for the WF stages:
  ``torch`` is the all-plain route;
* ``--device`` picks the torch device (default: the CUDA card; with no
  GPU and no ``--device`` the run fails rather than drop to the CPU);
* flags whose machinery is not ported yet exit non-zero naming their
  ``ROADMAP.md`` item;
* ``--on-error permissive`` quarantines malformed FASTQ records exactly
  as the reference's parser does, but does not wrap the session in the
  reference's ``ResilientMapper`` (not ported), on single-end and paired
  input alike: a healthy run writes the same SAM, and an engine fault
  fails the run.

Progress and the closing stats lines go to stderr, so ``-o -`` pipes
clean SAM to stdout.  ``main(argv)`` runs in-process.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

# the reference's flags whose machinery is not ported yet: parsed as the
# reference parses them, then refused naming their ROADMAP.md Queue 1
# item.  flag -> (argparse keywords, item)
_NOT_PORTED = {
    "--shards": (dict(type=int, default=None), 9),
    "--inject": (dict(default=None), 8),
    "--watchdog": (dict(type=float, default=None), 8),
    "--trace-out": (dict(default=None), 8),
    "--metrics-out": (dict(default=None), 8),
    "--log-json": (dict(action="store_true"), 8),
}


def _say(msg: str) -> None:
    print(msg, file=sys.stderr)


def _refuse_not_ported(ap: argparse.ArgumentParser, args) -> None:
    for flag, (_, item) in _NOT_PORTED.items():
        dest = flag[2:].replace("-", "_")
        if getattr(args, dest) != ap.get_default(dest):
            raise SystemExit(
                f"map_fastq: {flag} is not ported to repro_torch yet "
                f"(ROADMAP.md, Queue 1 item {item})")
    if args.topology != "single":
        raise SystemExit("map_fastq: --topology mesh is not ported to "
                         "repro_torch yet (ROADMAP.md, Queue 1 item 9)")


def _open_stream(args):
    """Build the FASTQ stream per input layout -> (stream, paired)."""
    from ..io.fastq import FastqStream, PairedFastqStream

    kw = dict(read_len=args.read_len, chunk_reads=args.chunk_reads,
              on_error=args.on_error, rejects=args.rejects)
    if args.r2 is not None and args.r1 is None:
        raise SystemExit("map_fastq: --r2 needs --r1")
    if args.r1 is not None:
        if args.reads is not None:
            raise SystemExit("map_fastq: pass either a positional FASTQ or "
                             "--r1/--r2, not both")
        if args.r2 is None:
            raise SystemExit("map_fastq: --r1 needs --r2 (or use "
                             "--interleaved with a single file)")
        if args.interleaved:
            raise SystemExit("map_fastq: --interleaved takes a single "
                             "positional FASTQ, not --r1/--r2")
        return PairedFastqStream(args.r1, args.r2, **kw), True
    if args.reads is None:
        raise SystemExit("map_fastq: no reads given (positional FASTQ or "
                         "--r1/--r2)")
    if args.interleaved:
        return PairedFastqStream(args.reads, interleaved=True, **kw), True
    return FastqStream(args.reads, **kw), False


def _print_mapper_stats(mapper, totals: dict, file=None) -> None:
    """Closing stats lines of a single-topology run (the single-topology
    part of ``repro.launch.serve._print_mapper_stats``): the unified
    MapperStats accounting, the session plan-cache counters, the arena's
    partition accounting of a sharded index and the index footprint."""
    print(f"filter/affine [single]: {totals['survivors']} "
          f"survivors -> {totals['affine_instances']} affine instances "
          f"(of {totals['padded_affine_instances']} padded), dropped "
          f"send={totals['dropped_send']} affine={totals['dropped_affine']}",
          file=file)
    print(f"plan cache: {mapper.plan_cache_hits} hits / "
          f"{mapper.plan_cache_misses} misses "
          f"(same-size batches reuse compiled executables after warm-up)",
          file=file)
    part = totals.get("partitions")
    if part:                          # shard-routed: the arena's account
        print(f"partitions: routed "
              f"{part['minis_routed_per_partition']} minimizers "
              f"(found {part['minis_found_per_partition']}) over "
              f"{part['chunks_routed']} chunk(s); arena "
              f"{part['arena_bytes']} B, {part['partition_loads']} "
              f"load(s), {part['partition_evictions']} eviction(s), "
              f"{part['h2d_bytes']} B h2d", file=file)
    stor = mapper.index_storage()
    per = stor.get("per_partition")
    breakdown = (" (" + ", ".join(
        f"p{d['partition']}: "
        f"{d['hash_table_bytes'] + d['segments_bytes']}"
        for d in per) + ")" if per else "")
    print(f"index storage: {stor['total_bytes']} B "
          f"(hash {stor['hash_table_bytes']} B + segments "
          f"{stor['materialized_segments_bytes']} B, blowup "
          f"{stor['blowup']:.1f}x){breakdown}", file=file)


def _open_sharded(args):
    """``--index-dir``: the opened index, with ``args.read_len`` taken
    from its manifest and ``--k/--w/--eth`` overridden by it (noted on
    stderr), as the reference does."""
    from ..index import open_index
    sharded = open_index(args.index_dir)
    if args.read_len is not None and args.read_len != sharded.read_len:
        raise SystemExit(
            f"map_fastq: --read-len {args.read_len} conflicts with the "
            f"index's read_len={sharded.read_len} — segment geometry "
            f"is fixed at build time; rebuild with "
            f"repro_torch.launch.build_index --read-len {args.read_len}")
    args.read_len = sharded.read_len
    for name in ("k", "w", "eth"):
        if getattr(args, name) != getattr(sharded, name):
            _say(f"map_fastq: --{name} {getattr(args, name)} ignored; "
                 f"index manifest has {name}={getattr(sharded, name)}")
            setattr(args, name, getattr(sharded, name))
    return sharded


def run(args) -> int:
    import torch

    from ..core.device import resolve_device
    from ..core.index import build_index
    from ..core.mapper import (Mapper, accumulate_partition_stats,
                               accumulate_stats, check_card_geometry)
    from ..core.pairing import InsertSizeTracker, resolve_pairs
    from ..core.pipeline import MapperConfig
    from ..io.fasta import ReferenceMap, load_reference
    from ..io.sam import emit_alignments, emit_paired_alignments, sam_header

    t0 = time.perf_counter()
    device = resolve_device(args.device)   # no GPU and no --device: raise
    if args.prefetch and args.index_dir is None:
        raise SystemExit(
            "map_fastq: --prefetch needs --index-dir with --topology "
            "single — only the shard-routed arena path has per-chunk "
            "partition uploads to overlap")
    sharded = _open_sharded(args) if args.index_dir is not None else None
    stream, paired = _open_stream(args)
    rl = stream.read_len
    cfg = MapperConfig(
        read_len=rl, k=args.k, w=args.w, eth=args.eth, engine=args.engine,
        wf_backend=args.wf_backend, chunk_reads=args.chunk_reads,
        stream=not args.no_stream, both_strands=not args.single_strand)
    check_card_geometry(cfg, device)    # before the FASTA load and index
    if sharded is not None:
        contigs = sharded.contigs
        # only the paired-end mate rescue needs the genome itself;
        # single-end runs stay on the memmapped packed reference
        ref = sharded.reference_codes() if paired else None
        n_indexed = sharded.ref_len
        idx = sharded
        src = (f"index {args.index_dir} ({sharded.num_partitions} "
               f"partitions)")
    else:
        # spacer >= one alignment window: no read can map across a boundary
        rejected_contigs: list = []
        ref, contigs = load_reference(args.reference,
                                      spacer=rl + 2 * args.eth,
                                      on_error=args.on_error,
                                      rejected=rejected_contigs)
        for cname, why in rejected_contigs:
            _say(f"map_fastq: skipped contig {cname!r}: {why}")
        n_indexed = len(ref)
        idx = build_index(ref, read_len=rl, k=args.k, w=args.w,
                          eth=args.eth, device=device,
                          backend=args.wf_backend)
        src = "in-memory index"
    refmap = ReferenceMap(contigs)
    budget = (int(args.index_budget_mb * (1 << 20))
              if args.index_budget_mb is not None else None)
    mapper = Mapper(idx, cfg, device=device, memory_budget_bytes=budget,
                    prefetch=args.prefetch)
    # mate rescue reads the genome: on the device once a run
    ref_dev = torch.from_numpy(ref).to(device) if paired else None
    _say(f"map_fastq: {len(contigs)} contig(s), {n_indexed} indexed bases "
         f"({src}), read_len={rl}, topology={mapper.topology}, "
         f"paired={paired}, both_strands={cfg.both_strands}, "
         f"engine={cfg.engine}, wf_backend={cfg.wf_backend}, "
         f"device={mapper.device}")

    # resume-safe atomic output: SAM accumulates in a .partial segment
    # and lands on the final path in one os.replace only after a clean
    # finish — an interrupted run can never leave a truncated file that
    # looks complete
    partial = None if args.output == "-" else args.output + ".partial"
    out = sys.stdout if partial is None else open(partial, "w")
    totals = dict(reads=0, mapped=0, reverse_best=0, survivors=0,
                  affine_instances=0, padded_affine_instances=0,
                  dropped_send=0, dropped_affine=0,
                  pairs=0, proper=0, rescued=0)
    saw_stats = False
    t_map = None
    tracker = InsertSizeTracker()
    contig_starts = [c.offset for c in contigs]
    try:
        for line in sam_header(contigs, command_line=args.command_line):
            out.write(line + "\n")
        t_map = time.perf_counter()
        for i, chunk in enumerate(stream):
            if paired:
                c1, c2 = chunk
                res1, res2 = mapper.map_pairs(c1.reads, c2.reads)
                pr = resolve_pairs(res1, res2, cfg=cfg, tracker=tracker,
                                   ref=ref_dev, reads1=c1.reads,
                                   reads2=c2.reads,
                                   contig_starts=contig_starts,
                                   device=device)
                for rec in emit_paired_alignments(
                        pr, c1.names, c1.reads, c1.quals, c2.reads,
                        c2.quals, refmap, seqs1=c1.seqs, seqs2=c2.seqs):
                    out.write(rec + "\n")
                n_new = 2 * len(c1)
                n_mapped = int(pr.res1.mapped.sum() + pr.res2.mapped.sum())
                res = res1  # stats object is shared by both halves
                for r in (pr.res1, pr.res2):
                    if r.strand is not None:
                        totals["reverse_best"] += int((r.strand
                                                       & r.mapped).sum())
                totals["pairs"] += pr.stats["n_pairs"]
                totals["proper"] += pr.stats["n_proper"]
                totals["rescued"] += pr.stats["n_rescued"]
                extra = (f", proper {pr.stats['n_proper']}/"
                         f"{pr.stats['n_pairs']} "
                         f"(insert median {pr.stats['insert_median']})")
            else:
                res = mapper.map(chunk.reads)
                for rec in emit_alignments(res, chunk.names, chunk.reads,
                                           chunk.quals, refmap,
                                           seqs=chunk.seqs):
                    out.write(rec + "\n")
                n_new = len(chunk)
                n_mapped = int(res.mapped.sum())
                # from the result, not stats: the padded engine has
                # stats=None
                if res.strand is not None:
                    totals["reverse_best"] += int((res.strand
                                                   & res.mapped).sum())
                extra = ""
            totals["reads"] += n_new
            totals["mapped"] += n_mapped
            if res.stats is not None:
                saw_stats = True
                accumulate_stats(totals, res.stats, fields=(
                    "survivors", "affine_instances",
                    "padded_affine_instances", "dropped_send",
                    "dropped_affine"))
                accumulate_partition_stats(totals, res.stats)
            out.flush()  # each chunk's records land in the .partial segment
            rate = totals["reads"] / max(time.perf_counter() - t_map, 1e-9)
            _say(f"chunk {i}: {n_new} reads, "
                 f"mapped {n_mapped / max(n_new, 1):.3f} "
                 f"(cumulative {totals['reads']} reads, {rate:.0f} reads/s)"
                 f"{extra}")
        complete = True
    except BaseException:
        complete = False
        raise
    finally:
        if out is not sys.stdout:
            out.close()
        if partial is not None:
            if complete:  # atomic landing: complete output or none
                os.replace(partial, args.output)
            else:
                _say(f"map_fastq: run did not complete; partial SAM left "
                     f"at {partial}")
        mapper.close()

    t_end = time.perf_counter()
    dt = t_end - t0
    skipped = (f", skipped {stream.n_skipped} short" if stream.n_skipped
               else "") + (f", truncated {stream.n_truncated} long"
                           if stream.n_truncated else "")
    _say(f"done: {totals['reads']} reads in {dt:.1f}s "
         f"({totals['reads'] / max(dt, 1e-9):.0f} reads/s incl. index "
         f"build; {totals['reads'] / max(t_end - t_map, 1e-9):.0f} reads/s "
         f"mapping and SAM), mapped {totals['mapped']} "
         f"({totals['reverse_best']} reverse-strand){skipped}")
    if stream.n_rejected:
        reasons = dict(stream.reject_reasons)
        subs = {id(s): s for s in (getattr(stream, "_s1", None),
                                   getattr(stream, "_s2", None))
                if s is not None}
        for s in subs.values():  # paired: fold in both mates' counts once
            for k, v in s.reject_reasons.items():
                reasons[k] = reasons.get(k, 0) + v
        where = f" -> {args.rejects}" if args.rejects else ""
        _say(f"quarantined: {stream.n_rejected} malformed record(s) "
             f"{reasons}{where}")
    if paired:
        lo, hi = tracker.window()
        _say(f"pairing: {totals['proper']}/{totals['pairs']} proper, "
             f"{totals['rescued']} rescued, insert median "
             f"{tracker.median} window [{lo}, {hi}]")
    if saw_stats:
        _print_mapper_stats(mapper, totals, file=sys.stderr)
    else:  # padded reference engine: no instance accounting to report
        _say(f"plan cache: {mapper.plan_cache_hits} hits / "
             f"{mapper.plan_cache_misses} misses")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.map_fastq",
        description="Map a FASTQ read set against a FASTA reference; "
                    "emit SAM.")
    ap.add_argument("reference", nargs="?", default=None,
                    help="FASTA reference (multi-contig ok; N -> "
                         "never-matching sentinel); omit when mapping "
                         "against a prebuilt --index-dir")
    ap.add_argument("reads", nargs="?", default=None,
                    help="FASTQ reads (4-line records; .gz ok) — "
                         "single-end, or interleaved pairs with "
                         "--interleaved")
    ap.add_argument("--index-dir", default=None, metavar="DIR",
                    help="prebuilt sharded index directory "
                         "(launch.build_index of either package) instead "
                         "of indexing a FASTA at startup; geometry comes "
                         "from the manifest")
    ap.add_argument("--index-budget-mb", type=float, default=None,
                    metavar="MB",
                    help="--index-dir: device budget for the partition "
                         "arena; partitions load lazily and LRU-evict "
                         "under this bound")
    ap.add_argument("--prefetch", action="store_true",
                    help="--index-dir: stage the next chunk's routing and "
                         "partition uploads on a background worker while "
                         "the current chunk computes (bit-identical "
                         "results)")
    ap.add_argument("--r1", default=None,
                    help="paired-end R1 FASTQ (.gz ok); requires --r2")
    ap.add_argument("--r2", default=None,
                    help="paired-end R2 FASTQ (.gz ok)")
    ap.add_argument("--interleaved", action="store_true",
                    help="the positional FASTQ holds interleaved R1/R2 "
                         "records")
    ap.add_argument("-o", "--output", default="-",
                    help="output SAM path ('-' = stdout; progress goes to "
                         "stderr either way)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--topology", default="single",
                    choices=("single", "mesh"))
    ap.add_argument("--chunk-reads", type=int, default=1024,
                    help="FASTQ batch size == engine streaming chunk")
    ap.add_argument("--read-len", type=int, default=None,
                    help="fixed read length (default: first FASTQ record)")
    ap.add_argument("--single-strand", action="store_true",
                    help="forward strand only (reverse-strand reads will "
                         "not map)")
    ap.add_argument("--engine", default="compacted",
                    choices=("compacted", "fused", "padded"))
    ap.add_argument("--wf-backend", default="cuda", choices=("cuda", "torch"))
    ap.add_argument("--no-stream", action="store_true",
                    help="synchronous debug path (per-stage timings)")
    ap.add_argument("--on-error", default="strict",
                    choices=("strict", "permissive"),
                    help="malformed-input policy: strict raises with "
                         "file:line context; permissive quarantines bad "
                         "records (counted; see --rejects) and keeps "
                         "mapping")
    ap.add_argument("--rejects", default=None,
                    help="permissive mode: write quarantined raw FASTQ "
                         "records to this file (.gz ok)")
    ap.add_argument("--k", type=int, default=12)
    ap.add_argument("--w", type=int, default=30)
    ap.add_argument("--eth", type=int, default=6)
    for flag, (kw, item) in _NOT_PORTED.items():
        ap.add_argument(flag, **kw, help=f"not ported yet (ROADMAP.md, "
                                         f"Queue 1 item {item})")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    args.command_line = " ".join(
        sys.argv if argv is None else ["repro_torch.launch.map_fastq",
                                       *argv])
    _refuse_not_ported(ap, args)
    if args.index_dir is not None:
        if args.reference is not None and args.reads is None:
            # `map_fastq --index-dir DIR reads.fq`: the sole positional
            # is the FASTQ — no FASTA on this path
            args.reference, args.reads = None, args.reference
        if args.reference is not None:
            raise SystemExit("map_fastq: pass either a FASTA reference or "
                             "--index-dir, not both")
    elif args.reference is None:
        raise SystemExit("map_fastq: a FASTA reference (positional) or "
                         "--index-dir is required")
    try:
        return run(args)
    except BrokenPipeError:
        # `map_fastq ... -o - | head` closing the pipe is not an error;
        # detach stdout so interpreter shutdown doesn't re-raise
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 141  # 128 + SIGPIPE, the conventional exit status


if __name__ == "__main__":
    raise SystemExit(main())
