"""``repro_torch`` stands alone: it imports with JAX made unimportable and
loads no module of the ``repro`` package, and so does ``chip_smoke.py``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

_PROBE = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import importlib
for name in {modules!r}:
    importlib.import_module(name)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m == "repro" or m.startswith(("repro.", "jax"))))
print("LOADED", bad)
"""


@pytest.mark.parametrize("modules", [
    ("repro_torch", "repro_torch.core", "repro_torch.core.mapper",
     "repro_torch.core.pairing", "repro_torch.kernels.ops", "repro_torch.kernels.build",
     "repro_torch.io.cigar", "repro_torch.io.fasta", "repro_torch.io.fastq",
     "repro_torch.io.sam", "repro_torch.data.genome",
     "repro_torch.launch.map_fastq"),
    ("repro_torch.configs", "repro_torch.configs.dartpim",
     "repro_torch.models", "repro_torch.models.layers",
     "repro_torch.models.transformer", "repro_torch.models.lm",
     "repro_torch.models.convert", "repro_torch.kernels.ops"),
    # the sharded index
    ("repro_torch.index", "repro_torch.index.residency",
     "repro_torch.launch.build_index"),
    # serving, resilience and observability
    ("repro_torch.obs", "repro_torch.obs.surfaces",
     "repro_torch.core.resilience", "repro_torch.core.serving",
     "repro_torch.launch.serve", "repro_torch.launch.report"),
    # the mesh topology
    ("repro_torch.core.distributed", "repro_torch.launch.mesh"),
    # the cost model and the moe, ssm and hybrid families
    ("repro_torch.core.costmodel", "repro_torch.core.index",
     "repro_torch.models.ssm", "repro_torch.models.transformer"),
    # the training half
    ("repro_torch.train", "repro_torch.train.optimizer",
     "repro_torch.train.checkpoint", "repro_torch.train.trainer",
     "repro_torch.data.tokens", "repro_torch.core.tree",
     "repro_torch.launch.train"),
    # the production mesh, the roofline and the dry run
    ("repro_torch.launch.mesh", "repro_torch.launch.roofline",
     "repro_torch.launch.dryrun", "repro_torch.configs.base"),
    # the flash wrapper's plain version, first in a fresh process
    ("repro_torch.core.attention", "repro_torch.kernels.ops",
     "repro_torch.models.layers"),
    ("chip_smoke",),
])
def test_imports_without_jax_or_repro(modules):
    code = _PROBE.format(src=str(SRC), root=str(ROOT), modules=modules)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_no_source_file_names_jax_or_repro():
    """Static check over every module of the package, including the ones a
    subprocess import would not reach."""
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)
