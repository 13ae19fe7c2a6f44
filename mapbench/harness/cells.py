"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix; the configuration's file is the one it lists, the mix is
``traffic/<traffic>.json``, the entry that the mix drives is
``entries/<entry>.py`` and each per-layer metric's reader is
``metrics/<metric>.py`` beside this folder.  Nothing here knows a cell,
a mix or a metric by name.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration's file
    traffic: dict         # traffic/<mix>.json
    chips: int
    end_to_end: list      # the metrics of BENCHMARK.json that this cell reports
    per_layer: list
    entry: object = None  # entries/<traffic["entry"]>.py


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(name=name, config=config, traffic=traffic, chips=w["chips"],
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)],
                entry=_module("entries", traffic["entry"]))


def _module(folder: str, name: str):
    """``<folder>/<name>.py`` beside this folder, loaded by its path."""
    path = BENCH_DIR / folder / f"{name}.py"
    key = f"mapbench_{folder}_{name.replace('-', '_').replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    return _module("metrics", name).read
