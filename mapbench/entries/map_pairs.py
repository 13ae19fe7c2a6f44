"""Entry ``map_pairs``: FR pairs through ``Mapper.map_pairs``, then
``repro_torch.core.pairing.resolve_pairs`` with a fresh
``InsertSizeTracker`` a call and mate rescue on the card.

Traffic keys: ``pairs_per_call``, ``errors`` (per-base sub/ins/del rates),
``insert_mean``, ``insert_sd``, ``r2_foreign_frac``; for the judgement
``judged_calls`` (calls drawn from the seed whose pairs are judged),
``sample_per_call`` pairs of each drawn at random and up to
``sample_lone_per_call`` more among those with one mate mapped.

Each batch's insert window comes from its own pairs.  The reference works
it out again from its own mapping of the batch's last pairs, as many as
hold the last ``KEEP_INSERTS`` facing pairs that the window is taken
from, and resolves the judged pairs under it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from mapbench.harness import compare as cmp
from mapbench.harness import genome as gen
from mapbench.harness.trace import span

SPANS = ("mapper.map_pairs", "pairing.resolve_pairs")
# pairing fields compared for every judged pair (after rescue)
MATE_FIELDS = ("position", "distance", "distance2", "mapped", "strand")
PAIR_FIELDS = ("proper", "insert", "mapq1", "mapq2", "rescued1",
               "rescued2") + tuple(f"{f}_{t}" for t in (1, 2)
                                   for f in MATE_FIELDS)
# pairs the reference maps at a time, from a batch's end, for its window
TAIL_BLOCK = 4352


def reads_per_call(traffic: dict) -> int:
    return 2 * traffic["pairs_per_call"]


def draw(traffic: dict, ref_dev: torch.Tensor, read_len: int,
         g: torch.Generator, calls: int, block: int) -> list:
    """``calls`` batches of the traffic, drawn on the device ``block``
    reads (``block // 2`` pairs) at a time, as host arrays."""
    n = traffic["pairs_per_call"]
    r1 = np.empty((calls * n, read_len), np.uint8)
    r2 = np.empty_like(r1)
    for a in range(0, calls * n, block // 2):
        b = min(a + block // 2, calls * n)
        p = gen.sample_pairs(ref_dev, b - a, read_len, traffic["errors"],
                             traffic["insert_mean"], traffic["insert_sd"],
                             traffic["r2_foreign_frac"], g)
        r1[a:b], r2[a:b] = p.reads1.cpu().numpy(), p.reads2.cpu().numpy()
    return [dict(reads1=r1[c * n:(c + 1) * n], reads2=r2[c * n:(c + 1) * n])
            for c in range(calls)]


def prepare(prog, ref: np.ndarray) -> None:
    """Rescue reads the reference's bases on the card."""
    prog.ref_dev = torch.from_numpy(ref).to(prog.mapper.device)


def call(prog, batch: dict, traced: bool) -> dict:
    from repro_torch.core.pairing import InsertSizeTracker, resolve_pairs
    r1, r2 = batch["reads1"], batch["reads2"]
    with span("mapper.map_pairs", traced):
        res1, res2 = prog.mapper.map_pairs(r1, r2)
    t0 = time.perf_counter()
    with span("pairing.resolve_pairs", traced):
        resolved = resolve_pairs(res1, res2, cfg=prog.cfg,
                                 tracker=InsertSizeTracker(),
                                 ref=prog.ref_dev, reads1=r1, reads2=r2,
                                 device=prog.mapper.device)
    return dict(res1=res1, res2=res2, resolved=resolved,
                pairing_s=time.perf_counter() - t0)


class Keeper:
    """A sample of every call's pairs drawn from the seed, the call's
    batch, and the counts that the per-layer metrics read."""

    def __init__(self, traffic: dict, seed: int):
        self.t = traffic
        self.seed = seed
        self.kept = []
        self.stats = dict(candidates=0, survivors=0, reads=0)
        self.pre = []            # each call's mates before resolution
        self.pairing_s = 0.0
        self.pairs = 0
        self.missing = 0

    def take(self, call_no: int, batch: dict, out: dict) -> None:
        res1, res2, resolved = out["res1"], out["res2"], out["resolved"]
        n = len(batch["reads1"])
        if len(res1.position) != n or len(resolved.proper) != n:
            self.missing += 2 * max(n - min(len(res1.position),
                                            len(resolved.proper)), 0)
            return
        pre = dict(pos1=np.asarray(res1.position), s1=np.asarray(res1.strand),
                   m1=np.asarray(res1.mapped, bool),
                   pos2=np.asarray(res2.position), s2=np.asarray(res2.strand),
                   m2=np.asarray(res2.mapped, bool))
        self.pre.append(pre)
        rng = cmp.rng(self.seed, call_no, 11)
        lone = np.flatnonzero(pre["m1"] ^ pre["m2"])
        rows = np.concatenate([
            rng.choice(n, size=min(self.t["sample_per_call"], n),
                       replace=False),
            rng.choice(lone, size=min(self.t["sample_lone_per_call"],
                                      len(lone)), replace=False)]).astype(
                                          np.int64)
        got = {f: np.asarray(getattr(resolved, f))[rows]
               for f in PAIR_FIELDS[:6]}
        for t, r in ((1, resolved.res1), (2, resolved.res2)):
            for f in MATE_FIELDS:
                got[f"{f}_{t}"] = np.asarray(getattr(r, f))[rows]
        self.kept.append(dict(batch=batch, rows=rows,
                              mate1=cmp.fields(res1, rows),
                              mate2=cmp.fields(res2, rows), got=got))
        self.stats["candidates"] += int(res1.stats.candidates)
        self.stats["survivors"] += int(res1.stats.survivors)
        self.stats["reads"] += 2 * n
        self.pairs += n
        self.pairing_s += out["pairing_s"]

    def context(self) -> dict:
        return dict(stats=self.stats, pairs=self.pairs,
                    pairing_s=self.pairing_s, pre=self.pre)

    def close(self) -> None:
        """Keep the ``judged_calls`` calls drawn from the seed."""
        n, cap = len(self.kept), self.t["judged_calls"]
        if n > cap:
            sel = np.sort(cmp.rng(self.seed, 12).choice(n, size=cap,
                                                        replace=False))
            self.kept = [self.kept[i] for i in sel]


def _map(idx, reads: np.ndarray) -> dict:
    from mapbench.reference.mapper import map_reads
    return map_reads(idx, torch.from_numpy(np.ascontiguousarray(reads)).to(
        idx.ref.device))


def own_windows(idx, reads1: np.ndarray, reads2: np.ndarray):
    """The batch's insert windows from the reference's own mapping of its
    last pairs: blocks of ``TAIL_BLOCK`` pairs from the end until they
    hold ``KEEP_INSERTS`` facing pairs (or the batch is exhausted), which
    is all that the window is taken from."""
    from mapbench.reference.pairing import (KEEP_INSERTS, fr_geometry,
                                            insert_windows)
    end, seen, parts = len(reads1), 0, []
    while end > 0 and seen < KEEP_INSERTS:
        a = max(0, end - TAIL_BLOCK)
        m1, m2 = _map(idx, reads1[a:end]), _map(idx, reads2[a:end])
        facing, _ = fr_geometry(m1["position"], m1["strand"],
                                m2["position"], m2["strand"],
                                idx.g.read_len)
        seen += int((facing & m1["mapped"] & m2["mapped"]).sum())
        parts.insert(0, (m1, m2))
        end = a
    f = {k: np.concatenate([p[i][key] for p in parts])
         for i, k, key in ((0, "pos1", "position"), (0, "s1", "strand"),
                           (0, "m1", "mapped"), (1, "pos2", "position"),
                           (1, "s2", "strand"), (1, "m2", "mapped"))}
    return insert_windows(f["pos1"], f["s1"], f["m1"], f["pos2"], f["s2"],
                          f["m2"], idx.g.read_len)


def reference_call(idx, batch: dict, rows: np.ndarray) -> dict:
    """What the reference gives for the judged pairs of one batch: each
    mate's mapping and the pairs' resolution under the batch's window."""
    from mapbench.reference.pairing import resolve
    r1, r2 = batch["reads1"][rows], batch["reads2"][rows]
    w1, w2 = _map(idx, r1), _map(idx, r2)
    windows = own_windows(idx, batch["reads1"], batch["reads2"])
    res = resolve(idx.ref, idx.g, {f: w1[f] for f in MATE_FIELDS},
                  {f: w2[f] for f in MATE_FIELDS}, r1, r2,
                  [windows] * len(rows))
    return dict(mate1=w1, mate2=w2, got=res)


def judge(keeper: Keeper, idx, control=None) -> dict:
    """The judged pairs resolved by the reference and compared field by
    field; with ``control`` the control's results stand in for the
    program's."""
    bad_reads = bad_pairs = n_pairs = 0
    for k in keeper.kept:
        want = reference_call(idx, k["batch"], k["rows"])
        got = dict(mate1=k["mate1"], mate2=k["mate2"], got=k["got"])
        if control is not None:
            ctl = reference_call(control, k["batch"], k["rows"])
            got = {key: {f: ctl[key][f] for f in got[key]} for key in got}
        bad_reads += (cmp.mismatched(got["mate1"], want["mate1"])
                      + cmp.mismatched(got["mate2"], want["mate2"]))
        bad_pairs += cmp.mismatched(got["got"], want["got"], PAIR_FIELDS)
        n_pairs += len(k["rows"])
    checks = dict(reads_mismatched=dict(value=bad_reads, limit=0),
                  pairs_mismatched=dict(value=bad_pairs, limit=0),
                  results_missing=dict(value=keeper.missing, limit=0))
    return dict(checks=checks, reads=2 * n_pairs, pairs=n_pairs)
