"""Milliseconds the caller waits inside ``mapper.run`` per million reads
handed to the entry: its ``sync`` spans (a host read of a device count)
and ``fetch_wait`` spans (the results of the fetch thread), from the
program's own record of the window."""
from mapbench.harness import spans


def read(ctx):
    s = spans.schedule(spans.record())
    if s is None or ctx["reads"] <= 0:
        return None
    return 1e3 * s["wait_s"] / (ctx["reads"] / 1e6)
