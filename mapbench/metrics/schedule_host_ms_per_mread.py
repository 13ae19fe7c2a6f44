"""Host milliseconds of the chunk schedule per million reads handed to the
entry: the caller's time in the program's ``mapper.run`` spans less the
part its ``sync`` and ``fetch_wait`` spans cover (the program's own record
of the window, ``repro_torch.obs.profiled()``)."""
from mapbench.harness import spans


def read(ctx):
    s = spans.schedule(spans.record())
    if s is None or ctx["reads"] <= 0:
        return None
    return 1e3 * (s["run_s"] - s["wait_s"]) / (ctx["reads"] / 1e6)
