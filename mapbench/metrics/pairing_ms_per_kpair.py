"""Host milliseconds of ``resolve_pairs`` (the benchmark's own span around
each call, host clock) per thousand pairs."""


def read(ctx):
    if not ctx["pairs"]:
        return None
    return 1e3 * ctx["pairing_s"] / (ctx["pairs"] / 1e3)
