"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: a
300,000-base reference, calls of 64 reads or pairs in chunks of 32, a
pool of two calls (``POOL_READS`` is set by ``conftest.py``)."""
import torch

from mapbench.harness.cells import load_cell

CPU = torch.device("cpu")
# the pool of a tiny run: two calls of 64 pairs
TINY_POOL_READS = 256


def tiny_cell(name: str, per_call: int = 64):
    cell = load_cell(name)
    cell.config["reference"]["genome_bases"] = 300_000
    cell.config["mapper"]["chunk_reads"] = 32
    t = cell.traffic
    t["reads_per_call" if "reads_per_call" in t else "pairs_per_call"] = \
        per_call
    return cell
