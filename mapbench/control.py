"""The control of the benchmark's correctness check: a run in which the
plain reference, computed with its cells saturating at 16 in place of the
configuration's 32 (4-bit values for the 5-bit cells of DART-PIM's Table
III: the narrower cell that would tempt a faster kernel), stands in the
program's place.  The check must read it as not correct.

    python3 mapbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 12

One process sets the cell up once, then for each seed draws the pool,
runs a window at the cell's own load (``--seconds``, long enough to keep
as many results as a run compares), and judges the kept results twice:
the program's (its reading on a sound run) and the control's.  One JSON
line a seed; not part of the benchmark's runs.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the control's cells: 4-bit values for the configuration's 5-bit ones
CONTROL_SAT = 16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from mapbench.harness import runner
    from mapbench.harness.cells import load_cell
    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ref, ref_dev, _, prog = runner.set_up(cell, device)
    print(json.dumps(dict(workload=args.workload,
                          setup_s=time.perf_counter() - T_PROCESS)),
          flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        batches = (runner.draw(cell, ref_dev, seed, 1, stream=2)[0],
                   runner.draw(cell, ref_dev, seed, runner.pool_calls(cell),
                               stream=1))
        w = runner.measure(cell, prog, batches, seed, args.seconds, False)
        keeper = w["keeper"]
        keeper.close()
        t0 = time.perf_counter()
        sound = runner.judge(cell, ref_dev, keeper)
        t1 = time.perf_counter()
        control = runner.judge(cell, ref_dev, keeper,
                               control_sat=CONTROL_SAT)
        print(json.dumps(dict(
            seed=seed, calls=w["calls"], reads_per_s=w["attempted"]
            / w["window_s"], compared=sound["reads"],
            pairs=sound["pairs"], program=sound["checks"],
            control=control["checks"], control_sat=CONTROL_SAT,
            reference_s=t1 - t0)), flush=True)
    prog.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
