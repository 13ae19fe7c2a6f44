"""One run of one cell: set-up, warm-up, the measured window, the judgement
against the plain reference, and the result line.

Set-up (counted in ``setup_s``, from the process's start): the
configuration's reference sequence from its own fixed seed, on the
device; from ``--seed``, a warm-up batch and a pool of ``POOL_READS``
distinct reads in whole calls, drawn on the device; the program's index
(``repro_torch.core.index.build_index`` on the device) and ``Mapper``;
one warm-up call on its own batch.  The window then calls the traffic's
entry (``entries/<entry>.py``) back to back, one caller, each call's
results on the host before the next starts, until ``--seconds`` have
passed; the window ends with the last call.  Calls take the pool's
batches in order.

The entry keeps a sample of the results, drawn from the seed; once the
window has closed, the device memory peak been read and the program's
state freed, the reference works them out again itself and every kept
field is compared exactly.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from mapbench.harness import genome as gen
from mapbench.harness import trace as tr
from mapbench.harness.cells import Cell, metric_reader

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# reads the window's pool holds, in whole calls: distinct reads, so that no
# read comes back within a window of the present rates (§2 of PERF.md)
POOL_READS = 1 << 24
# reads the generator draws on the device at a time
DRAW_BLOCK = 1 << 19


class Program:
    """The system under test, set up for one cell: the index, the
    ``Mapper`` and what the cell's entry prepares beside them."""

    def __init__(self, cell: Cell, ref: np.ndarray, device):
        from repro_torch.core.index import build_index
        from repro_torch.core.mapper import Mapper
        from repro_torch.core.pipeline import MapperConfig
        m = cell.config["mapper"]
        self.cfg = MapperConfig(**m)
        self.index = build_index(
            ref, read_len=m["read_len"], k=m["k"], w=m["w"], eth=m["eth"],
            max_pls_per_minimizer=cell.config["index"]["max_pls_per_minimizer"],
            device=device)
        self.mapper = Mapper(self.index, self.cfg, device=device)
        self.ref_dev = None
        cell.entry.prepare(self, ref)

    def close(self):
        self.mapper.close()
        self.mapper = self.index = self.ref_dev = None


def pool_calls(cell: Cell) -> int:
    return max(POOL_READS // cell.entry.reads_per_call(cell.traffic), 1)


def draw(cell: Cell, ref_dev: torch.Tensor, seed: int, calls: int,
         stream: int) -> list:
    """``calls`` batches of the cell's traffic from one stream of ``seed``
    (stream 1: the window's pool; stream 2: the warm-up batch)."""
    return cell.entry.draw(cell.traffic, ref_dev,
                           cell.config["mapper"]["read_len"],
                           gen.generator(ref_dev.device, seed, stream),
                           calls, DRAW_BLOCK)


def judge(cell: Cell, ref_dev: torch.Tensor, keeper,
          control_sat: int | None = None) -> dict:
    """The reference's judgement of the kept results (the entry's
    ``judge`` over the reference's own index of the bases).  Returns the
    numbers compared with their limits and the counts behind them.

    ``control_sat``: the control.  The reference computed with that
    saturation is put in the program's place."""
    from mapbench.reference.mapper import Geometry, Index
    m = cell.config["mapper"]
    t0 = time.perf_counter()
    idx = Index(ref_dev, Geometry.of(m))
    t1 = time.perf_counter()
    control = (idx.with_geometry(Geometry.of(m, sat=control_sat))
               if control_sat is not None else None)
    out = cell.entry.judge(keeper, idx, control)
    out.update(index_s=t1 - t0, map_s=time.perf_counter() - t1)
    return out


def device_info(device) -> dict:
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=1)
    return dict(platform="cpu", kind="cpu", count=1)


def set_up(cell: Cell, device, seed: int | None = None):
    """(reference bases, the bases on the device, the warm-up batch and the
    pool of ``seed`` (None without a seed), the program set up for the
    cell).  The batches are drawn before the program exists and the
    device's memory peak is reset after them, so the peak a run reports is
    the program's."""
    device = torch.device(device)
    conf = cell.config["reference"]
    t0 = time.perf_counter()
    ref_dev = gen.make_reference(conf["genome_bases"], conf["seed"],
                                 conf["repeat_frac"], conf["repeat_len"],
                                 device)
    ref = ref_dev.cpu().numpy()
    t1 = time.perf_counter()
    batches = None
    if seed is not None:
        batches = (draw(cell, ref_dev, seed, 1, stream=2)[0],
                   draw(cell, ref_dev, seed, pool_calls(cell), stream=1))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t2 = time.perf_counter()
    prog = Program(cell, ref, device)
    prog.set_up_s = dict(reference=t1 - t0, pool=t2 - t1,
                         program=time.perf_counter() - t2)
    return ref, ref_dev, batches, prog


def measure(cell: Cell, prog: Program, batches: tuple, seed: int,
            seconds: float, traced: bool, t_process: float | None = None):
    """One warm-up call on its own batch, then the window, which takes the
    pool's batches in order.  Returns a dict of the keeper, calls,
    attempted reads, window_s, each call's seconds, the pool's wraps,
    setup_s and the profiler (traced runs)."""
    dev = prog.mapper.device
    warm, pool = batches
    cell.entry.call(prog, warm, False)             # the cell's shapes
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gc.collect()
    keeper = cell.entry.Keeper(cell.traffic, seed)
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t_win = time.perf_counter()
    calls = 0
    ends = []
    with tr.span(tr.WINDOW_SPAN, traced):
        while True:
            batch = pool[calls % len(pool)]
            out = cell.entry.call(prog, batch, traced)
            keeper.take(calls, batch, out)
            calls += 1
            ends.append(time.perf_counter() - t_win)
            if ends[-1] >= seconds:
                break
    window_s = time.perf_counter() - t_win
    if prof is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.__exit__(None, None, None)
    return dict(keeper=keeper, calls=calls,
                attempted=calls * cell.entry.reads_per_call(cell.traffic),
                window_s=window_s, prof=prof, wraps=(calls - 1) // len(pool),
                call_s=np.diff(np.concatenate([[0.0], ends])).tolist(),
                setup_s=(t_win - t_process if t_process is not None
                         else None))


def run(cell: Cell, seed: int, seconds: float, traced: bool, *, device,
        t_process: float) -> tuple[dict, int]:
    """One run; returns (result line, exit code)."""
    clock = [("start", t_process)]
    ref, ref_dev, batches, prog = set_up(cell, device, seed)
    clock.append(("set_up", time.perf_counter()))
    dev = prog.mapper.device
    w = measure(cell, prog, batches, seed, seconds, traced, t_process)
    clock.append(("warm_up_and_window", time.perf_counter()))
    keeper, calls, attempted = w["keeper"], w["calls"], w["attempted"]
    window_s, setup_s, prof = w["window_s"], w["setup_s"], w["prof"]
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    set_up_parts = prog.set_up_s
    prog.close()
    keeper.close()
    del prog, batches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    breakdown = None
    dinfo = device_info(dev)
    dinfo["memory_peak_bytes"] = int(peak)
    if traced:
        summary = tr.summarize(tr.export(prof), cell.entry.SPANS)
        del prof
        ctx = dict(cell=cell, summary=summary,
                   reads=attempted - keeper.missing, genome_len=len(ref),
                   **keeper.context())
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        dinfo["busy_s"] = summary["busy_s"]
        dinfo["window_s"] = summary["window_s"]
        breakdown = dict(device_ops=tr.top(summary["device_s"]),
                         idle_gaps=tr.top(summary["idle_by_host"]))
        clock.append(("trace", time.perf_counter()))
    else:
        done = attempted - keeper.missing
        e2e = dict(reads_per_s=done / window_s, setup_s=setup_s,
                   peak_device_gib=peak / 2**30)
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = dict(value=e2e[m["name"]],
                                          unit=m["unit"])

    verdict = judge(cell, ref_dev, keeper)
    clock.append(("judge", time.perf_counter()))
    set_up_parts.update(judge_index=verdict["index_s"],
                        judge_map=verdict["map_s"])
    checks = verdict["checks"]
    correct = verdict["reads"] > 0 and all(c["value"] <= c["limit"]
                                           for c in checks.values())
    result = dict(correct=bool(correct), attempted=int(attempted),
                  failed=int(keeper.missing), metrics=metrics, device=dinfo)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["calls"] = calls
    result["pool_wraps"] = w["wraps"]
    result["window_s"] = window_s
    result["call_s"] = [round(x, 4) for x in w["call_s"]]
    result["phase_s"] = {b[0]: b[1] - a[1] for a, b in zip(clock, clock[1:])}
    result["phase_s"].update(set_up_parts)
    result["compared"] = dict(reads=verdict["reads"], pairs=verdict["pairs"])
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    bad = sorted({mod for mod in sys.modules
                  if mod.split(".")[0] in FORBIDDEN})
    if bad:
        print(f"modules that the run may not load: {bad}", file=sys.stderr)
        return result, 3
    return result, 0
