"""End-to-end example: the distributed read-mapping SERVICE on the
PyTorch/CUDA port — batched requests against a sharded index on a shard
mesh, through the ``Mapper`` session API (the twin of
``examples/map_service.py``).

    PYTHONPATH=src python examples/map_service_torch.py \
        [--shards 8 --batches 5]                     # on the CUDA card
    PYTHONPATH=src python examples/map_service_torch.py --device cpu

The mesh is the local form: ``--shards`` logical shards on one device,
with the all_to_all seeding exchange a transpose in device memory, the
per-shard WF compute and the result reduce — the full DART-PIM dataflow
of Fig. 6 at mesh scale.  Repeated same-size batches hit the session plan
cache (one mesh program), which the closing line shows.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.index import build_index  # noqa: E402
from repro_torch.core.mapper import Mapper  # noqa: E402
from repro_torch.data.genome import make_reference, sample_reads  # noqa: E402
from repro_torch.launch.mesh import make_genomics_mesh  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--batch-reads", type=int, default=64)
    ap.add_argument("--genome", type=int, default=40_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    mesh = make_genomics_mesh(args.shards, device=args.device)
    print(f"mesh: {mesh}")
    ref = make_reference(args.genome, seed=0, repeat_frac=0.02)
    idx = build_index(ref, device=mesh.device)
    mapper = Mapper(idx, topology="mesh", mesh=mesh)
    print(f"index sharded {args.shards} ways "
          f"({len(idx.uniq_kmers)} minimizers)")

    total, correct, dropped, t_total = 0, 0, 0, 0.0
    for b in range(args.batches):
        rs = sample_reads(ref, args.batch_reads, seed=100 + b)
        t0 = time.perf_counter()
        res = mapper.map(rs.reads)
        dt = time.perf_counter() - t0
        t_total += dt
        total += len(res.position)
        correct += int((np.abs(res.position - rs.true_pos) <= 6).sum())
        dropped += res.stats.dropped_send
        print(f"batch {b}: {len(res.position)} reads in {dt * 1e3:.0f} ms "
              f"({len(res.position) / dt:.0f} reads/s), "
              f"dropped={res.stats.dropped_send}")
    print(f"\nservice accuracy: {correct / total:.3f} over {total} reads "
          f"({dropped} dropped); steady-state {total / t_total:.0f} reads/s "
          f"on {mesh.device}")
    print(f"plan cache: {mapper.plan_cache_hits} hits / "
          f"{mapper.plan_cache_misses} misses — warm batches reuse the "
          f"mesh program")


if __name__ == "__main__":
    main()
