"""Device milliseconds of the mapper's five kernels (linear_wf,
affine_wf_dist, affine_wf, affine_traceback, minimizer_scan; the
profiler's kernel time by name) per million reads handed to the entry."""


def read(ctx):
    ms = 1e3 * sum(ctx["summary"]["kernel_s"].values())
    if ms <= 0 or ctx["reads"] <= 0:
        return None
    return ms / (ctx["reads"] / 1e6)
