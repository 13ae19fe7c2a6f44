"""Blocking host reads of device values per ``Mapper.run`` call: the
program's ``sync`` spans inside its ``mapper.run`` spans, over the
``mapper.run`` spans, from its own record of the window."""
from mapbench.harness import spans


def read(ctx):
    s = spans.schedule(spans.record())
    if s is None:
        return None
    return s["syncs"] / s["runs"]
