"""Bytes the chunk schedule copies from the device to the host per read
handed to the entry: the ``bytes`` of the program's ``d2h`` spans (one a
chunk, on the fetch thread), from its own record of the window."""
from mapbench.harness import spans


def read(ctx):
    c = spans.copies(spans.record())
    if c is None or ctx["reads"] <= 0:
        return None
    return c["bytes"] / ctx["reads"]
