"""Genomics mapping service launcher — torch twin of
``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --shards 8 \
        --reads 256                        # on the CUDA card
    PYTHONPATH=src python -m repro_torch.launch.serve --service \
        --batches 16
    PYTHONPATH=src python -m repro_torch.launch.serve --service \
        --topology mesh --shards 4 --batches 4 --genome 20000 --device cpu

Both modes drive the ``Mapper`` session:

  * distributed (default) — ``Mapper(topology="mesh")`` batch loop over
    ``--shards`` logical shards on the device (``launch.mesh``);
  * ``--service`` — variable-sized request batches coalesced by the
    pow-2 ``ReadBatcher`` into bucket shapes (``core.serving``):
    ``--topology single`` streams buckets through the chunk engine,
    ``--topology mesh`` maps each bucket on the distributed mapper, where
    same-size buckets hit the session plan cache.

The command line is the reference's, with the differences of the port's
``map_fastq``: ``--wf-backend cuda|torch`` (default ``cuda``) and
``--device`` (default: the CUDA card).  ``--profiler-port`` reports that
torch has no profiler server and continues.
"""
from __future__ import annotations

import argparse
import sys
import time


def run_service(args) -> int:
    import numpy as np

    from ..core.device import resolve_device
    from ..core.index import build_index
    from ..core.mapper import Mapper
    from ..core.pipeline import MapperConfig
    from ..core.serving import BatcherConfig
    from ..data.genome import make_reference, sample_reads
    from ..obs import logjson
    from .report import print_mapper_stats

    device = resolve_device(args.device)
    ref = make_reference(args.genome, seed=0, repeat_frac=0.02)
    idx = build_index(ref, device=device, backend=args.wf_backend)
    if args.topology == "mesh":
        # the mesh cuts its shards on the host: the flat index leaves the
        # card before they are placed there
        idx = idx.to("cpu")
    cfg = MapperConfig.from_index(idx, wf_backend=args.wf_backend,
                                  stream=not args.no_stream)
    mapper = Mapper(idx, cfg, topology=args.topology, n_shards=args.shards,
                    device=device)
    svc = mapper.serve(BatcherConfig(bucket_min=args.bucket_min,
                                     bucket_max=args.bucket_max))
    rng = np.random.default_rng(7)
    logjson.say(f"service: genome {len(ref)} bases, buckets "
                f"[{args.bucket_min}..{args.bucket_max}], "
                f"topology={mapper.topology}, stream={cfg.stream}, "
                f"wf_backend={cfg.wf_backend}, device={mapper.device}",
                event="start", file=sys.stdout,
                genome=len(ref), topology=mapper.topology)
    total = correct = 0
    t0 = time.perf_counter()
    truth = {}
    for _ in range(args.batches):
        # a burst of variable-sized client requests, then one flush
        for _ in range(int(rng.integers(1, 5))):
            n = int(rng.integers(1, args.reads + 1))
            rs = sample_reads(ref, n, seed=int(rng.integers(1 << 30)))
            truth[svc.submit(rs.reads)] = rs.true_pos
        for rid, res in svc.flush().items():
            total += len(res.position)
            correct += int((np.abs(res.position - truth.pop(rid)) <= 6).sum())
    dt = time.perf_counter() - t0
    mapper.close()
    st = svc.batcher.stats
    waste = st["padded_reads"] / max(st["padded_reads"] + st["reads"], 1)
    logjson.say(f"{total} reads / {st['requests']} requests in {dt:.1f}s "
                f"({total / dt:.0f} reads/s), accuracy "
                f"{correct / max(total, 1):.4f}",
                event="done", file=sys.stdout, reads=total,
                requests=st["requests"], wall_s=round(dt, 3),
                accuracy=round(correct / max(total, 1), 4))
    print(f"bucket hist {st['bucket_hist']}, lane padding waste {waste:.3f}")
    print_mapper_stats(mapper, svc.totals)
    return 0


def run_distributed(args) -> int:
    import numpy as np

    from ..core.device import resolve_device
    from ..core.index import build_index
    from ..core.mapper import Mapper, accumulate_stats
    from ..core.pipeline import MapperConfig
    from ..data.genome import make_reference, sample_reads
    from .mesh import make_genomics_mesh
    from .report import print_mapper_stats

    device = resolve_device(args.device)
    mesh = make_genomics_mesh(args.shards, device=device)
    n_shards = mesh.n_shards
    ref = make_reference(args.genome, seed=0, repeat_frac=0.02)
    # the mesh cuts its shards on the host: the flat index leaves the card
    # before they are placed there
    idx = build_index(ref, device=device, backend=args.wf_backend).to("cpu")
    cfg = MapperConfig.from_index(idx, wf_backend=args.wf_backend)
    mapper = Mapper(idx, cfg, topology="mesh", mesh=mesh,
                    send_cap=args.send_cap)
    print(f"serving: {n_shards} shards, {len(idx.uniq_kmers)} minimizers, "
          f"{len(ref)} bases")
    totals = dict(survivors=0, affine_instances=0,
                  padded_affine_instances=0, dropped_send=0,
                  dropped_affine=0, reverse_best=0)
    total = correct = 0
    t0 = time.perf_counter()
    for b in range(args.batches):
        rs = sample_reads(ref, args.reads, seed=1000 + b)
        res = mapper.map(rs.reads)
        total += len(res.position)
        correct += int((np.abs(res.position - rs.true_pos) <= 6).sum())
        accumulate_stats(totals, res.stats)
    dt = time.perf_counter() - t0
    print(f"{total} reads in {dt:.1f}s ({total / dt:.0f} reads/s), "
          f"accuracy {correct / total:.4f}, dropped {totals['dropped_send']}")
    print_mapper_stats(mapper, totals)
    return 0


def run(args) -> int:
    """``run_service`` or ``run_distributed`` inside the observability
    surfaces asked for: the
    ``--log-json`` / ``--metrics-out`` (a final snapshot) /
    ``--trace-out`` ones of ``map_fastq``, plus ``--metrics-port``
    (Prometheus exposition thread) and ``--profiler-port``."""
    from ..obs import logjson
    from ..obs import registry as _metrics
    from ..obs import server as obs_server
    from ..obs.surfaces import obs_surfaces

    with obs_surfaces("serve", trace_out=args.trace_out,
                      metrics_out=args.metrics_out, log_json=args.log_json,
                      arm_metrics=(args.metrics_out is not None
                                   or args.metrics_port is not None),
                      final_snapshot=True):
        srv = None
        if args.metrics_port is not None:
            srv = obs_server.start_metrics_server(_metrics.ACTIVE,
                                                  port=args.metrics_port)
            logjson.say(f"serve: metrics exposition on "
                        f"http://{srv.host}:{srv.port}/metrics",
                        event="metrics_server", port=srv.port)
        if (args.profiler_port is not None and
                obs_server.start_profiler_server(args.profiler_port) is None):
            logjson.say("serve: torch profiler server unavailable on this "
                        "torch build; continuing without it",
                        event="profiler_server", port=None)
        try:
            return (run_service if args.service else run_distributed)(args)
        finally:
            if srv is not None:
                srv.stop()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--service", action="store_true",
                    help="request batcher + Mapper session service mode")
    ap.add_argument("--topology", default="single",
                    choices=("single", "mesh"),
                    help="service mode only: execute buckets on the "
                         "single-device streaming engine or route them "
                         "onto the distributed mesh mapper")
    ap.add_argument("--shards", type=int, default=None,
                    help="mesh shard count (default: one per device the "
                         "mesh spans, so 1 on one card)")
    ap.add_argument("--genome", type=int, default=50_000)
    ap.add_argument("--reads", type=int, default=128,
                    help="reads per batch (distributed) / max request size "
                         "(service)")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--send-cap", type=int, default=None,
                    help="distributed mode: per-destination send "
                         "capacity (default: scaled from the batch)")
    ap.add_argument("--bucket-min", type=int, default=64)
    ap.add_argument("--bucket-max", type=int, default=1024)
    ap.add_argument("--wf-backend", default="cuda", choices=("cuda", "torch"))
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--no-stream", action="store_true",
                    help="service mode only: synchronous path (per-stage "
                         "timings)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export the run as Chrome trace-event JSON "
                         "(Perfetto / chrome://tracing)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a final JSONL metrics snapshot (schema: "
                         "schemas/metrics_snapshot.schema.json)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="expose the live metrics registry over HTTP "
                         "(Prometheus text on /metrics, JSON on "
                         "/metrics.json; 0 = ephemeral port)")
    ap.add_argument("--profiler-port", type=int, default=None,
                    metavar="PORT",
                    help="the reference's profiler server; torch has none, "
                         "so the run says so and continues")
    ap.add_argument("--log-json", action="store_true",
                    help="structured one-object-per-line JSON progress "
                         "on stderr")
    return ap


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
