"""Share of the traced window in which nothing ran on the device (kernels,
copies, fills), from the profiler's trace."""


def read(ctx):
    s = ctx["summary"]
    if s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
