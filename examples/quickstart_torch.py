"""Quickstart on the PyTorch/CUDA port: index a genome, open a Mapper
session, map reads, print alignments and the index's lowTh split (the
twin of ``examples/quickstart.py``).

    python examples/quickstart_torch.py [--genome 50000 --reads 32]
    python examples/quickstart_torch.py --device cpu     # no GPU
    (PYTHONPATH handled below)
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.core.index import build_index, low_th_split  # noqa: E402
from repro_torch.core.mapper import Mapper  # noqa: E402
from repro_torch.data.genome import make_reference, sample_reads  # noqa: E402
from repro_torch.io.cigar import cigar_from_ops  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=int, default=50_000)
    ap.add_argument("--reads", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(f"== DART-PIM on PyTorch ({device}): quickstart ==")
    ref = make_reference(args.genome, seed=0, repeat_frac=0.02)
    idx = build_index(ref, device=device)
    print(f"reference: {len(ref)} bases; index: {len(idx.uniq_kmers)} "
          f"minimizers, {len(idx.positions)} occurrences, "
          f"segment length {idx.seg_len}")
    sb = idx.storage_bytes()
    print(f"storage blow-up (paper ~17x on HG38): {sb['blowup']:.1f}x")
    # paper Sec. V-A: minimizers seen at most lowTh times go to RISC-V
    s = low_th_split(idx, low_th=3)
    print(f"lowTh=3 split: {s['n_rare_minimizers']} of {s['n_minimizers']} "
          f"minimizers rare ({s['rare_minimizer_fraction']:.4f}), "
          f"{s['rare_pl_fraction']:.4f} of the PL work")

    # the Mapper session owns device placement + the plan cache; inspect
    # the execution plan before running anything
    mapper = Mapper(idx, device=device)
    plan = mapper.plan(args.reads)
    print(f"\nplan: engine={plan.engine} chunks={plan.chunk_sizes} "
          f"(quantum {plan.chunk}), linear/affine instance ceilings "
          f"{plan.lin_cap_max}/{plan.aff_cap_max}")

    rs = sample_reads(ref, args.reads, seed=1)
    res = mapper.run(plan, rs.reads)
    acc = (np.abs(res.position - rs.true_pos) <= 6).mean()
    print(f"mapped {res.mapped.sum()}/{args.reads} reads; "
          f"accuracy(+-band) = {acc:.3f}")
    print(f"stats: {res.stats.candidates} candidates -> "
          f"{res.stats.survivors} survivors -> "
          f"{res.stats.affine_instances} affine instances\n")
    for i in range(min(5, args.reads)):
        print(f"read {i}: true={rs.true_pos[i]:>6} "
              f"mapped={res.position[i]:>6} dist={res.distance[i]} "
              f"cigar={cigar_from_ops(res.ops[i], res.op_count[i])}")


if __name__ == "__main__":
    main()
