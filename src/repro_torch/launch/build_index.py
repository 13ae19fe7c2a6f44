"""Build a persistent sharded genome index from a FASTA, out of core — the
twin of ``repro.launch.build_index``, writing the same files.

    PYTHONPATH=src python -m repro_torch.launch.build_index ref.fa \
        -o ref.idx --partitions 8 --tile-bp 1048576     # on the CUDA card
    PYTHONPATH=src python -m repro_torch.launch.build_index ref.fa \
        -o ref.idx --device cpu             # kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.map_fastq \
        --index-dir ref.idx reads.fq -o out.sam

One pass over the FASTA in ``--tile-bp`` tiles (host memory is bounded
by the tile, not the genome), partitioned by ``hash32(kmer) %
partitions``; the output directory holds a versioned JSON manifest,
per-partition memmap CSR files with 2-bit packed segments, and the 2-bit
packed reference — everything ``map_fastq --index-dir`` needs, in either
package.

The command line is the reference's, with the differences of the port's
``map_fastq``: ``--wf-backend cuda|torch`` picks the tiles' minimizer
scan (the kernel, or the plain version) and ``--device`` the torch
device (default: the CUDA card).  ``--trace-out`` (scan and
per-partition finalize spans), ``--metrics-out`` (a final snapshot) and
``--log-json`` write what the reference's do.
"""
from __future__ import annotations

import argparse
import time


def run(args) -> int:
    from ..index import build_sharded_index, verify_index
    from ..obs import logjson
    from ..obs.surfaces import obs_surfaces

    with obs_surfaces("build_index", trace_out=args.trace_out,
                      metrics_out=args.metrics_out, log_json=args.log_json,
                      final_snapshot=True):
        t0 = time.perf_counter()

        def say(msg):
            logjson.say(f"build_index: {msg}", event="progress")
        idx = build_sharded_index(
            args.reference, args.output, num_partitions=args.partitions,
            tile_bp=args.tile_bp, read_len=args.read_len, k=args.k,
            w=args.w, eth=args.eth, max_pls_per_minimizer=args.max_pls,
            overwrite=args.force, origin=args.origin, progress=say,
            device=args.device, backend=args.wf_backend)
        if args.verify:
            verify_index(args.output)
            say("full integrity check passed")
        stor = idx.storage_bytes()
        bstats = (idx.manifest or {}).get("build", {})
        dt = time.perf_counter() - t0
        logjson.say(
            f"build_index: {args.output}: {idx.num_partitions} "
            f"partitions, {len(idx.contigs)} contig(s), {idx.ref_len} "
            f"bases, {idx.n_occurrences} occurrences, "
            f"{stor['total_bytes']} B on disk ({stor['blowup']:.1f}x "
            f"segment blowup), {bstats.get('spill_bytes', 0)} spill B "
            f"in {dt:.1f}s",
            event="done", partitions=idx.num_partitions,
            ref_len=idx.ref_len, occurrences=idx.n_occurrences,
            bytes_on_disk=stor["total_bytes"],
            spill_bytes=bstats.get("spill_bytes", 0), wall_s=round(dt, 3))
        return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.build_index",
        description="Build a sharded on-disk genome index from a FASTA "
                    "(streamed; bounded memory).")
    ap.add_argument("reference", help="FASTA reference (multi-contig ok; "
                                      "N -> never-matching sentinel)")
    ap.add_argument("-o", "--output", required=True,
                    help="output index directory")
    ap.add_argument("--partitions", type=int, default=4,
                    help="partition count (power of two)")
    ap.add_argument("--tile-bp", type=int, default=1 << 20,
                    help="scan tile size in bases — the peak-memory knob")
    ap.add_argument("--read-len", type=int, default=150,
                    help="read length the segment geometry is sized for")
    ap.add_argument("--k", type=int, default=12)
    ap.add_argument("--w", type=int, default=30)
    ap.add_argument("--eth", type=int, default=6)
    ap.add_argument("--max-pls", type=int, default=256,
                    help="occurrence cap per hyper-repetitive minimizer")
    ap.add_argument("--origin", type=int, default=0,
                    help="global position of the reference's first base "
                         "(format v2): occurrence positions are recorded "
                         "at origin + offset, so multi-host builds can "
                         "split one coordinate space")
    ap.add_argument("--force", action="store_true",
                    help="rebuild over an existing index directory")
    ap.add_argument("--verify", action="store_true",
                    help="re-read and digest-check every file after the "
                         "build")
    ap.add_argument("--wf-backend", default="cuda", choices=("cuda", "torch"),
                    help="the tiles' minimizer scan: the kernel (cuda) or "
                         "its plain version (torch)")
    ap.add_argument("--device", default=None,
                    help="torch device of the scan (default: the CUDA card; "
                         "'cpu' runs the kernel's plain version)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export the build as Chrome trace-event JSON "
                         "(scan + per-partition finalize spans)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a final JSONL metrics snapshot (schema: "
                         "schemas/metrics_snapshot.schema.json)")
    ap.add_argument("--log-json", action="store_true",
                    help="structured one-object-per-line JSON progress "
                         "on stderr")
    return ap


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
