"""Entry ``map``: single-end reads through ``Mapper.map``.

Traffic keys: ``reads_per_call``, ``errors`` (per-base sub/ins/del rates),
``revcomp_frac``, ``foreign_frac``, ``sample_per_call`` (results a call
keeps for the judgement), ``sample_max`` (kept results a run judges).
"""
from __future__ import annotations


import numpy as np
import torch

from mapbench.harness import compare as cmp
from mapbench.harness import genome as gen
from mapbench.harness.trace import span

SPANS = ("mapper.map",)


def reads_per_call(traffic: dict) -> int:
    return traffic["reads_per_call"]


def draw(traffic: dict, ref_dev: torch.Tensor, read_len: int,
         g: torch.Generator, calls: int, block: int) -> list:
    """``calls`` batches of the traffic, drawn on the device ``block``
    reads at a time, handed to the program as host arrays."""
    n = traffic["reads_per_call"]
    reads = np.empty((calls * n, read_len), np.uint8)
    for a in range(0, calls * n, block):
        b = min(a + block, calls * n)
        reads[a:b] = gen.sample_reads(
            ref_dev, b - a, read_len, traffic["errors"],
            traffic["revcomp_frac"], traffic["foreign_frac"],
            g).reads.cpu().numpy()
    return [dict(reads=reads[c * n:(c + 1) * n]) for c in range(calls)]


def prepare(prog, ref: np.ndarray) -> None:
    """Nothing beyond the index and the ``Mapper``."""


def call(prog, batch: dict, traced: bool) -> dict:
    with span("mapper.map", traced):
        return dict(res=prog.mapper.map(batch["reads"]))


class Keeper:
    """A few results of every call, drawn from the seed, and the counts
    that the per-layer metrics read."""

    def __init__(self, traffic: dict, seed: int):
        self.t = traffic
        self.seed = seed
        self.kept = []
        self.stats = dict(candidates=0, survivors=0, reads=0)
        self.missing = 0

    def take(self, call_no: int, batch: dict, out: dict) -> None:
        res = out["res"]
        n = len(batch["reads"])
        if len(res.position) != n:
            self.missing += max(n - len(res.position), 0)
            return
        rows = cmp.rng(self.seed, call_no, 11).choice(
            n, size=min(self.t["sample_per_call"], n), replace=False)
        self.kept.append(dict(reads=batch["reads"][rows],
                              got=cmp.fields(res, rows)))
        self.stats["candidates"] += int(res.stats.candidates)
        self.stats["survivors"] += int(res.stats.survivors)
        self.stats["reads"] += n

    def context(self) -> dict:
        """What the per-layer metrics read beside the trace."""
        return dict(stats=self.stats, pairs=0, pairing_s=0.0, pre=[])

    def close(self) -> None:
        """Keep at most ``sample_max`` reads, drawn from the seed, so that
        the reference's time stays bounded."""
        if not self.kept:
            return
        k = cmp.concat(self.kept)
        n, cap = len(k["reads"]), self.t["sample_max"]
        if n > cap:
            sel = np.sort(cmp.rng(self.seed, 12).choice(n, size=cap,
                                                        replace=False))
            k = dict(reads=k["reads"][sel],
                     got={f: v[sel] for f, v in k["got"].items()})
        self.kept = [k]


def judge(keeper: Keeper, idx, control=None) -> dict:
    """The kept reads mapped by the reference (``idx``, a
    ``reference.mapper.Index``) and compared field by field.  With
    ``control`` (an Index of another geometry) the control's results are
    judged in the program's place."""
    from mapbench.reference.mapper import map_reads
    checks = dict(reads_mismatched=dict(value=0, limit=0),
                  results_missing=dict(value=keeper.missing, limit=0))
    if not keeper.kept:
        return dict(checks=checks, reads=0, pairs=0)
    k = keeper.kept[0]
    dev = idx.ref.device
    reads = torch.from_numpy(k["reads"]).to(dev)
    want = map_reads(idx, reads)
    got = k["got"]
    if control is not None:
        ctl = map_reads(control, reads)
        got = {f: ctl[f] for f in got}
    checks["reads_mismatched"]["value"] = cmp.mismatched(got, want)
    return dict(checks=checks, reads=len(k["reads"]), pairs=0)
