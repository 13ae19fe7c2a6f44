"""FASTA + FASTQ -> SAM, end-to-end over the ``Mapper`` session — torch
twin of ``repro.launch.map_fastq``.

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
    PYTHONPATH=src python -m repro_torch.launch.map_fastq ref.fa reads.fq \
        -o out.sam --topology mesh --shards 8

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
``--topology mesh --shards N`` maps each chunk on the distributed mapper
over N logical shards on the device (``core.distributed``; with
``--index-dir`` partition *i* is shard *i*); its stage B computes
distances and positions only, so mesh records carry CIGAR ``*``
(strand, POS and pairing still present).

The command line is the reference's, with these differences:

* ``--wf-backend`` takes ``cuda|torch`` (default ``cuda``), for the
  index build's minimizer scan and seeding as for the WF stages:
  ``torch`` is the all-plain route;
* ``--device`` picks the torch device (default: the CUDA card; with no
  GPU and no ``--device`` the run fails rather than drop to the CPU);
* the ``done:`` line adds the rate without the index build.

``--inject`` or ``--on-error permissive`` wrap the session in a
``ResilientMapper`` (retry, bisection, the ``fused -> compacted``
ladder); ``--trace-out``, ``--metrics-out`` and ``--log-json`` write the
reference's Chrome trace, metrics JSONL and JSON log lines.

Progress and the closing stats lines go to stderr, so ``-o -`` pipes
clean SAM to stdout.  ``main(argv)`` runs in-process.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

def _say(msg: str) -> None:
    print(msg, file=sys.stderr)


def _open_stream(args, injector=None):
    """Build the FASTQ stream per input layout -> (stream, paired)."""
    from ..io.fastq import FastqStream, PairedFastqStream

    kw = dict(read_len=args.read_len, chunk_reads=args.chunk_reads,
              on_error=args.on_error, rejects=args.rejects,
              injector=injector)
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


def _ingest(stream):
    """Enumerate FASTQ chunks, stamping the span context with the chunk
    index and recording each chunk's host-side parse as an ``ingest``
    span when tracing is armed."""
    from ..obs import tracing as _tracing
    it = iter(stream)
    i = 0
    while True:
        if _tracing.ACTIVE is not None:
            _tracing.set_ctx(chunk=i)
        t0 = time.perf_counter()
        try:
            chunk = next(it)
        except StopIteration:
            return
        tr = _tracing.ACTIVE
        if tr is not None:
            tr.add("ingest", t0, time.perf_counter())
        yield i, chunk
        i += 1


def _span(name):
    from ..obs.tracing import span
    return span(name)


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
    """Entry point: arms the ``--log-json`` / ``--metrics-out`` /
    ``--trace-out`` surfaces around the mapping run and always tears
    them down."""
    from ..obs.surfaces import obs_surfaces

    with obs_surfaces("map_fastq", trace_out=args.trace_out,
                      metrics_out=args.metrics_out,
                      log_json=args.log_json) as fresh:
        args.obs_fresh_registry = fresh
        return _run(args)


def _run(args) -> int:
    import torch

    from ..core.device import resolve_device
    from ..core.index import build_index
    from ..core.mapper import (Mapper, accumulate_partition_stats,
                               accumulate_stats, check_card_geometry,
                               totals_from_registry)
    from ..core.pairing import InsertSizeTracker, resolve_pairs
    from ..core.pipeline import MapperConfig
    from ..core.resilience import FaultInjector, ResilientMapper
    from ..io.fasta import ReferenceMap, load_reference
    from ..io.sam import emit_alignments, emit_paired_alignments, sam_header
    from ..obs import logjson
    from ..obs.surfaces import metrics_snapshot
    from .report import print_mapper_stats

    t0 = time.perf_counter()
    device = resolve_device(args.device)   # no GPU and no --device: raise
    injector = (FaultInjector.from_spec(args.inject)
                if args.inject is not None else None)
    if args.prefetch and (args.index_dir is None
                          or args.topology != "single"):
        raise SystemExit(
            "map_fastq: --prefetch needs --index-dir with --topology "
            "single — only the shard-routed arena path has per-chunk "
            "partition uploads to overlap")
    sharded = _open_sharded(args) if args.index_dir is not None else None
    stream, paired = _open_stream(args, injector)
    rl = stream.read_len
    cfg = MapperConfig(
        read_len=rl, k=args.k, w=args.w, eth=args.eth, engine=args.engine,
        wf_backend=args.wf_backend, chunk_reads=args.chunk_reads,
        stream=not args.no_stream, both_strands=not args.single_strand)
    # before the FASTA load and index
    check_card_geometry(cfg, device, topology=args.topology)
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
        if args.topology == "mesh":
            # the mesh cuts its shards on the host: the flat index leaves
            # the card before they are placed there
            idx = idx.to("cpu")
        src = "in-memory index"
    refmap = ReferenceMap(contigs)
    budget = (int(args.index_budget_mb * (1 << 20))
              if args.index_budget_mb is not None else None)
    mapper = Mapper(idx, cfg, topology=args.topology, n_shards=args.shards,
                    device=device, injector=injector,
                    watchdog_s=args.watchdog, memory_budget_bytes=budget,
                    prefetch=args.prefetch)
    # fault containment (retry/bisect/degrade) is armed alongside the
    # injector or a permissive run; a strict run fails fast, unwrapped
    resilient = (ResilientMapper(mapper, injector=injector)
                 if injector is not None or args.on_error == "permissive"
                 else None)
    # mate rescue reads the genome: on the device once a run
    ref_dev = torch.from_numpy(ref).to(device) if paired else None
    logjson.say(
        f"map_fastq: {len(contigs)} contig(s), {n_indexed} indexed bases "
        f"({src}), read_len={rl}, topology={mapper.topology}, "
        f"paired={paired}, both_strands={cfg.both_strands}, "
        f"engine={cfg.engine}, wf_backend={cfg.wf_backend}, "
        f"device={mapper.device}",
        event="start", contigs=len(contigs), indexed_bases=n_indexed,
        read_len=rl, topology=mapper.topology, paired=paired,
        engine=cfg.engine, wf_backend=cfg.wf_backend)

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
        n_chunks = 0
        for i, chunk in _ingest(stream):
            n_chunks = i + 1
            if paired:
                c1, c2 = chunk
                if resilient is not None:
                    res1, res2, _ = resilient.map_pairs(c1.reads, c2.reads)
                    if res1 is None:  # every block failed after retries
                        _say(f"chunk {i}: all {2 * len(c1)} reads failed "
                             f"after retries; chunk quarantined")
                        totals["reads"] += 2 * len(c1)
                        continue
                else:
                    res1, res2 = mapper.map_pairs(c1.reads, c2.reads)
                pr = resolve_pairs(res1, res2, cfg=cfg, tracker=tracker,
                                   ref=ref_dev, reads1=c1.reads,
                                   reads2=c2.reads,
                                   contig_starts=contig_starts,
                                   device=device)
                with _span("sam_emit"):
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
                if resilient is not None:
                    res, _, _ = resilient.map(chunk.reads)
                    if res is None:  # every block failed after retries
                        _say(f"chunk {i}: all {len(chunk)} reads failed "
                             f"after retries; chunk quarantined")
                        totals["reads"] += len(chunk)
                        continue
                else:
                    res = mapper.map(chunk.reads)
                with _span("sam_emit"):
                    for rec in emit_alignments(res, chunk.names,
                                               chunk.reads, chunk.quals,
                                               refmap, seqs=chunk.seqs):
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
            metrics_snapshot(args.metrics_out, seq=i)
            rate = totals["reads"] / max(time.perf_counter() - t_map, 1e-9)
            logjson.say(
                f"chunk {i}: {n_new} reads, "
                f"mapped {n_mapped / max(n_new, 1):.3f} "
                f"(cumulative {totals['reads']} reads, {rate:.0f} reads/s)"
                f"{extra}",
                event="chunk", chunk=i, reads=n_new, mapped=n_mapped,
                cumulative_reads=totals["reads"],
                reads_per_s=round(rate, 1))
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
    logjson.say(
        f"done: {totals['reads']} reads in {dt:.1f}s "
        f"({totals['reads'] / max(dt, 1e-9):.0f} reads/s incl. index "
        f"build; {totals['reads'] / max(t_end - t_map, 1e-9):.0f} reads/s "
        f"mapping and SAM), mapped {totals['mapped']} "
        f"({totals['reverse_best']} reverse-strand){skipped}",
        event="done", reads=totals["reads"], mapped=totals["mapped"],
        wall_s=round(dt, 3))
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
    if resilient is not None:
        rc = resilient.counters
        if any(rc.values()) or resilient.ladder.degraded:
            _say(f"resilience: {rc['retries']} retries, "
                 f"{rc['failed_reads']} quarantined reads in "
                 f"{rc['failed_blocks']} block(s), engine ladder "
                 f"{resilient.ladder.describe()}")
    if paired:
        lo, hi = tracker.window()
        _say(f"pairing: {totals['proper']}/{totals['pairs']} proper, "
             f"{totals['rescued']} rescued, insert median "
             f"{tracker.median} window [{lo}, {hi}]")
    if saw_stats:
        if args.obs_fresh_registry:
            # the engine counters from the metrics registry, so the
            # closing lines and the snapshots cannot disagree (the
            # registry counts every engine run)
            derived = totals_from_registry(mapper.topology)
            for k in ("survivors", "affine_instances",
                      "padded_affine_instances", "dropped_send",
                      "dropped_affine"):
                totals[k] = derived[k]
        print_mapper_stats(mapper, totals, file=sys.stderr)
    else:  # padded reference engine: no instance accounting to report
        _say(f"plan cache: {mapper.plan_cache_hits} hits / "
             f"{mapper.plan_cache_misses} misses")
    metrics_snapshot(args.metrics_out, seq=n_chunks)
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
    ap.add_argument("--shards", type=int, default=None,
                    help="mesh topology: shard count (default: one per "
                         "device the mesh spans, so 1 on one card)")
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
    ap.add_argument("--inject", default=None, metavar="SPEC",
                    help="deterministic fault injection, e.g. "
                         "'bucket=0.125,record=0.005,seed=3' (sites: "
                         "bucket, record, stall, error, flush; plus "
                         "seed=, stall_s=, poison=r1;r2, "
                         "engines=fused;cuda) — chaos testing")
    ap.add_argument("--watchdog", type=float, default=None, metavar="S",
                    help="streaming fetch watchdog seconds: a stalled "
                         "chunk fetch fails (and is retried/quarantined) "
                         "instead of hanging the run")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export the run as Chrome trace-event JSON "
                         "(loadable in Perfetto / chrome://tracing): each "
                         "chunk's stages, syncs and copies as spans")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write JSONL metrics snapshots (one per chunk "
                         "plus a final one; schema: "
                         "schemas/metrics_snapshot.schema.json)")
    ap.add_argument("--log-json", action="store_true",
                    help="structured one-object-per-line JSON progress "
                         "on stderr instead of human-readable lines")
    ap.add_argument("--k", type=int, default=12)
    ap.add_argument("--w", type=int, default=30)
    ap.add_argument("--eth", type=int, default=6)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    args.command_line = " ".join(
        sys.argv if argv is None else ["repro_torch.launch.map_fastq",
                                       *argv])
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
