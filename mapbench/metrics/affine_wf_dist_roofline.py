"""The affine distance kernel's share of its roofline: the least time an
H100 needs for the window's filter survivors and, on the paired path, its
rescue rows (counts/work.py, counts/wf_bound.py, frozen), over the
profiler's time of ``affine_dist_kernel`` in every call, the rescue
sweeps included."""
from mapbench.counts.wf_bound import bound_ms
from mapbench.counts.work import rescue_rows


def read(ctx):
    t = 1e3 * ctx["summary"]["kernel_s"]["affine_wf_dist"]
    m = ctx["cell"].config["mapper"]
    R = ctx["stats"]["survivors"] + sum(
        rescue_rows(p, m["read_len"], ctx["genome_len"]) for p in ctx["pre"])
    if t <= 0 or R <= 0:
        return None
    least, _ = bound_ms("affine_wf_dist", R, m["read_len"], m["eth"])
    return 100.0 * least / t
