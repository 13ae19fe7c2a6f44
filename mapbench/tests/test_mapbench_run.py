"""Whole runs of tiny cells on the CPU, the look for a card skipped: a sound
run reads correct, the control and every fault the cells can have read as
not correct, and ``BENCHMARK.json`` keeps to the benchmark's contract."""
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from _tiny import CPU, tiny_cell
from mapbench.harness import runner

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
SE, PE = "se150-wgs", "pe150-wgs"


def _run(cell, seconds=0.0, traced=False):
    return runner.run(cell, 2**31 + 99, seconds, traced, device=CPU,
                      t_process=time.perf_counter())


def _stale(orig):
    """Each call hands back the previous call's results."""
    last = []

    def map_(self, reads):
        last.append(orig(self, reads))
        return last[-2] if len(last) > 1 else last[-1]
    return map_


def _half(orig):
    """Only the first half of the batch is mapped; the rest reads as
    unmapped."""
    from repro_torch.core.pipeline import MappingResult

    def map_(self, reads):
        n, h = len(reads), len(reads) // 2
        res = orig(self, reads[:h])
        cfg = self.cfg
        fill = dict(position=-1, distance=cfg.sat_affine,
                    distance2=cfg.sat_affine, mapped=False, strand=0, ops=4,
                    op_count=0, n_candidates=0, linear_dist=cfg.eth + 1)
        cols = {f: (None if getattr(res, f) is None else np.concatenate([
            getattr(res, f), np.full((n - h,) + getattr(res, f).shape[1:], v,
                                     getattr(res, f).dtype)]))
                for f, v in fill.items()}
        return MappingResult(**cols, stats=res.stats)
    return map_


def _altered(orig):
    """Every 7th read's position is off by one where it is produced."""
    def map_(self, reads):
        res = orig(self, reads)
        res.position[::7] += 1
        return res
    return map_


FAULTS = {"stale": _stale, "half": _half, "altered": _altered}


@pytest.mark.parametrize("name", [SE, PE])
def test_sound_run_is_correct(name):
    res, rc = _run(tiny_cell(name))
    assert rc == 0 and res["correct"], res["checks"]
    assert res["compared"]["reads"] > 0
    assert list(res)[-1] == "checks"
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert set(res["metrics"]) == e2e


@pytest.mark.parametrize("name", [SE, PE])
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_fault_reads_as_not_correct(name, fault, monkeypatch):
    from repro_torch.core.mapper import Mapper
    # Mapper.map_pairs maps both mates through Mapper.map
    monkeypatch.setattr(Mapper, "map", FAULTS[fault](Mapper.map))
    res, rc = _run(tiny_cell(name))
    assert rc == 0 and not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("name", [SE, PE])
def test_control_reads_as_not_correct(name):
    cell = tiny_cell(name)
    ref, ref_dev, batches, prog = runner.set_up(cell, CPU, seed=5)
    w = runner.measure(cell, prog, batches, 5, 0.0, False)
    keeper = w["keeper"]
    keeper.close()
    sound = runner.judge(cell, ref_dev, keeper)["checks"]
    control = runner.judge(cell, ref_dev, keeper, control_sat=16)["checks"]
    assert all(c["value"] == 0 for c in sound.values())
    assert control["reads_mismatched"]["value"] > 0


def test_traced_run_reads_its_layers():
    res, rc = _run(tiny_cell(PE), traced=True)
    assert rc == 0 and res["correct"]
    m = res["metrics"]
    for name in ("candidates_per_read", "filter_survivor_pct",
                 "pairing_ms_per_kpair", "device_idle_pct"):
        assert name in m and m[name]["value"] >= 0
    # no device kernels on the CPU: the kernel metrics read nothing
    assert "linear_wf_roofline" not in m
    assert res["device"]["window_s"] > 0
    assert "breakdown" in res


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["mapbench"] and 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("mapbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        body = json.load(open(os.path.join(ROOT, c["file"])))
        assert sorted(body["reduced"]) == sorted(c["reduced"])
    sources = [c["source"] for c in b["configs"]]
    assert len(set(sources)) == len(sources)
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "mapbench", "traffic",
                                           w["traffic"] + ".json"))
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["moves"] in e2e
        assert os.path.exists(os.path.join(ROOT, "mapbench", "metrics",
                                           m["name"] + ".py"))
        for cell in m["workloads"]:
            assert cell in CELLS
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in CELLS:
        assert any(cell in m.get("workloads", CELLS) for m in b["per_layer"])


@pytest.mark.card
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    out = subprocess.run(
        [sys.executable, "mapbench/run.py", "--workload", SE, "--seed",
         "2147483701", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "mapbench/run.py", "--workload", SE, "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
