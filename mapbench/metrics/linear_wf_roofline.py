"""The linear filter kernel's share of its roofline: the least time an
H100 needs for the valid candidates of the window's reads (counts/
wf_bound.py, frozen), over the profiler's time of ``linear_wf_kernel``."""
from mapbench.counts.wf_bound import bound_ms


def read(ctx):
    t = 1e3 * ctx["summary"]["kernel_s"]["linear_wf"]
    R = ctx["stats"]["candidates"]
    if t <= 0 or R <= 0:
        return None
    m = ctx["cell"].config["mapper"]
    least, _ = bound_ms("linear_wf", R, m["read_len"], m["eth"])
    return 100.0 * least / t
