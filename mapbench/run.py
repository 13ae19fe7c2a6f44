"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 mapbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  It measures ``repro_torch``'s read mapper
on one CUDA card; see ``mapbench/README.md`` for what a run does, how a
cell, a traffic mix or a metric is added as new files, and where the
kernels' build cache lives.  The last line of standard output is the
result, one JSON object; the numbers compared with the reference are the
last lines of standard error.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    try:
        import torch
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"mapbench: the program cannot be imported here: {e}",
              file=sys.stderr)
        return 2
    # one process with few threads: the mapper's host work is numpy, and
    # torch's CPU threads only contend with it
    torch.set_num_threads(1)
    from mapbench.harness.cells import load_cell
    from mapbench.harness.runner import run
    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"mapbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, rc = run(cell, args.seed, args.seconds, bool(args.trace),
                     device=torch.device("cuda", 0), t_process=T_PROCESS)
    if rc:
        return rc
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
