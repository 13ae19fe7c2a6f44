"""Host milliseconds of ``resolve_pairs`` per thousand pairs: the
program's own ``resolve_pairs`` spans (mate rescue included), from its
record of the window."""
from mapbench.harness import spans


def read(ctx):
    s = spans.seconds(spans.record(), "resolve_pairs")
    if s is None or not ctx["pairs"]:
        return None
    return 1e3 * s / (ctx["pairs"] / 1e3)
