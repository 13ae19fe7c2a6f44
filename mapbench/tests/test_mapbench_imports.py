"""What a run may import: no module under ``mapbench/`` (its tests apart)
has ``jax``, ``jaxlib``, ``flax`` or ``repro`` as its top-level import name,
compared as whole names (``repro_torch`` is the program and passes), and
the reference imports nothing of ``repro_torch``."""
import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _sources(sub=""):
    for d, dirs, files in os.walk(os.path.join(BENCH, sub)):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_or_reference_package():
    found = {(os.path.relpath(p, ROOT), n) for p in _sources()
             for n in _top_names(p) if n in FORBIDDEN}
    assert not found


def test_reference_imports_nothing_of_the_program():
    found = {(os.path.relpath(p, ROOT), n)
             for sub in ("reference",) for p in _sources(sub)
             for n in _top_names(p) if n == "repro_torch"}
    assert not found
    # and nothing that reaches it: its imports are torch, numpy and itself
    allowed = {"__future__", "dataclasses", "numpy", "torch"}
    for p in _sources("reference"):
        tree = ast.parse(open(p).read(), p)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                continue
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] in allowed, (p, n)


def test_modules_loaded_by_the_harness():
    """Importing the harness, the reference, the counts and every metric
    reader in a fresh interpreter loads no forbidden top-level module."""
    code = (
        "import sys, pathlib\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'src')!r}]\n"
        "import mapbench.harness.runner, mapbench.reference.pairing\n"
        "import mapbench.counts.work, repro_torch.core.mapper\n"
        "import repro_torch.core.pairing, repro_torch.core.index\n"
        "from mapbench.harness.cells import metric_reader, BENCH_DIR\n"
        "for p in (BENCH_DIR / 'metrics').glob('*.py'):\n"
        "    metric_reader(p.stem)\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        f"set({sorted(FORBIDDEN)!r}))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("name", ["jax", "repro"])
def test_whole_name_comparison(name):
    # the run's own check compares top-level names whole
    from mapbench.harness.runner import FORBIDDEN as RUN_FORBIDDEN
    assert name in RUN_FORBIDDEN
    assert "repro_torch".split(".")[0] not in RUN_FORBIDDEN
