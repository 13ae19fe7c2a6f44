"""The per-layer metrics that read the program's own spans: each reader
gives its value on a record of spans built by hand, None on an empty
record and where the program has no record at all (as a program without
the span hook), and a traced run of each tiny cell on the CPU gives every
metric its cells list."""
import json
import os
import time

import pytest

from _tiny import CPU, tiny_cell
from mapbench.harness import runner
from mapbench.harness.cells import metric_reader

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAMES = ("schedule_host_ms_per_mread", "host_wait_ms_per_mread",
         "syncs_per_call", "d2h_bytes_per_read", "d2h_pageable_pct",
         "resolve_pairs_ms_per_kpair")


def _record(monkeypatch, build):
    """The program's record replaced by a tracer filled by ``build``."""
    from repro_torch import obs
    from repro_torch.obs.tracing import Tracer
    rec = Tracer()
    build(rec)
    monkeypatch.setattr(obs, "profiled", lambda: rec)


def _two_calls(rec):
    """Two calls of 2,000,000 reads (ids 1 and 10).  Call 1: 1.0 s, a
    0.1 s sync and a 0.2 s fetch_wait, a host_prep 0.3 s holding a 0.05 s
    sync (a grandchild); call 10: 0.5 s with one 0.1 s sync.  Three
    fetches on another thread, 1 MB pageable and 3 MB pinned, and a 0.1 s
    and a 0.3 s resolve_pairs of 1,000 pairs."""
    a = rec.add
    a("sync", 0.1, 0.2, {"site": "n_valid"}, sid=2, parent=1)
    a("sync", 0.40, 0.45, {"site": "survivors"}, sid=4, parent=3)
    a("host_prep", 0.3, 0.6, None, sid=3, parent=1)
    a("fetch_wait", 0.7, 0.9, None, sid=5, parent=1)
    a("mapper.run", 0.0, 1.0, {"reads": 2_000_000}, sid=1, parent=None)
    a("sync", 2.1, 2.2, {"site": "n_valid"}, sid=11, parent=10)
    a("mapper.run", 2.0, 2.5, {"reads": 2_000_000}, sid=10, parent=None)
    for i, (n, pageable) in enumerate(((1 << 20, True), (1 << 20, False),
                                       (2 << 20, False))):
        a("d2h", 0.5, 0.6, {"bytes": n, "copies": 3, "pageable": pageable},
          sid=20 + i, parent=None)
    a("resolve_pairs", 3.0, 3.1, {"pairs": 1000}, sid=30, parent=None)
    a("resolve_pairs", 3.2, 3.5, {"pairs": 1000}, sid=31, parent=None)


CTX = dict(reads=4_000_000, pairs=2000)
WANT = {
    # 1.5 s of mapper.run less 0.45 s of syncs and waits under it
    "schedule_host_ms_per_mread": 1050.0 / 4,
    "host_wait_ms_per_mread": 450.0 / 4,
    "syncs_per_call": 3 / 2,
    "d2h_bytes_per_read": (4 << 20) / 4_000_000,
    "d2h_pageable_pct": 25.0,
    "resolve_pairs_ms_per_kpair": 400.0 / 2,
}


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_a_hand_built_record(name, monkeypatch):
    _record(monkeypatch, _two_calls)
    assert metric_reader(name)(CTX) == pytest.approx(WANT[name], rel=1e-9)


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_an_empty_record(name, monkeypatch):
    _record(monkeypatch, lambda rec: None)
    assert metric_reader(name)(CTX) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_without_the_programs_record(name, monkeypatch):
    from repro_torch import obs
    monkeypatch.delattr(obs, "profiled")
    assert metric_reader(name)(CTX) is None


def test_reader_of_other_spans_only(monkeypatch):
    """A record without the spans a reader reads gives None there."""
    def only_pairs(rec):
        rec.add("resolve_pairs", 0.0, 0.1, {"pairs": 10}, sid=1)
    _record(monkeypatch, only_pairs)
    got = {n: metric_reader(n)(CTX) for n in NAMES}
    assert got.pop("resolve_pairs_ms_per_kpair") == pytest.approx(50.0)
    assert got == {n: None for n in NAMES[:-1]}


@pytest.mark.parametrize("name", ["se150-wgs", "pe150-wgs"])
def test_tiny_traced_run_reads_every_span_metric(name):
    res, rc = runner.run(tiny_cell(name), 2**31 + 7, 0.0, True, device=CPU,
                         t_process=time.perf_counter())
    assert rc == 0 and res["correct"], res["checks"]
    m = res["metrics"]
    for entry in BENCH["per_layer"]:
        if entry["name"] in NAMES and name in entry["workloads"]:
            assert m[entry["name"]]["value"] > 0, entry["name"]
            assert m[entry["name"]]["unit"] == entry["unit"]
    assert m["d2h_pageable_pct"]["value"] == 100.0
    # the tiny cells' calls: 64 reads (pairs: 128) in chunks of 32 rows
    chunks = 2 if name == "se150-wgs" else 4
    sites = 2 if name == "se150-wgs" else 1
    assert m["syncs_per_call"]["value"] == chunks * sites
