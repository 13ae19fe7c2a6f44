import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
# the checkout's root (for ``mapbench``) and its src/ (for ``repro_torch``)
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped with a reason elsewhere")


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _tiny_pool(monkeypatch):
    """Tiny runs draw a pool of a few calls, not the cells' full pool."""
    from _tiny import TINY_POOL_READS
    from mapbench.harness import runner
    monkeypatch.setattr(runner, "POOL_READS", TINY_POOL_READS)
