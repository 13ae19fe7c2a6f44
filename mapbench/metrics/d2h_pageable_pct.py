"""Share of the chunk schedule's device-to-host bytes that land in
pageable (not pinned) host memory: the ``pageable`` flag of the program's
``d2h`` spans, weighted by their ``bytes``."""
from mapbench.harness import spans


def read(ctx):
    c = spans.copies(spans.record())
    if c is None or c["bytes"] <= 0:
        return None
    return 100.0 * c["pageable"] / c["bytes"]
