"""Reading a ``torch.profiler`` trace of the measured window.

The window runs inside one ``torch.profiler`` profile with CPU and CUDA
activity.  Its Chrome trace export gives, on one clock: the device's
kernels, copies and fills, the host's operator events, and the
benchmark's own spans (``torch.profiler.record_function``:
``WINDOW_SPAN`` around the whole window, one around each call into a
layer).  ``summarize`` reduces it to:

  * ``window_s``: the length of the window span;
  * ``busy_s``: the union of device activity inside it;
  * ``device_s``: seconds of device time by operation name, and
    ``kernel_s`` those of the mapper's kernels by kernel;
  * ``idle_by_host``: the device's idle gaps inside the window, summed by
    what the host was doing: the innermost benchmark span open at the
    gap's middle and the longest host operator open there ("-" for
    Python with no operator).
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile

import torch

WINDOW_SPAN = "mapbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the mapper's kernels: a substring of the device function's name -> key
KERNELS = {"linear_wf_kernel": "linear_wf",
           "affine_dist_kernel": "affine_wf_dist",
           "affine_wf_kernel": "affine_wf",
           "affine_traceback_kernel": "affine_traceback",
           "minimizer_kernel": "minimizer_scan"}
# idle gaps labelled by host activity: the longest ones, shorter gaps are
# summed under "other"
LABELLED_GAPS = 4000


def span(name: str, on: bool):
    """A benchmark span of the trace (``record_function``) where ``on``."""
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


def export(prof) -> dict:
    """The profiler's Chrome trace as a dict (written to a temporary file
    under ``TMPDIR`` and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def short_name(name: str) -> str:
    """A device function's name without its parameter list and return type."""
    name = re.sub(r"\(.*$", "", name)
    return name.replace("void ", "").strip()[:80]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(trace: dict, spans: tuple) -> dict:
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e.get("name") == WINDOW_SPAN
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = []
    device_s: dict[str, float] = {}
    kernel_s = {k: 0.0 for k in KERNELS.values()}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        dev.append((a, b))
        name = short_name(e["name"])
        device_s[name] = device_s.get(name, 0.0) + (b - a) * 1e-6
        for sub, key in KERNELS.items():
            if sub in e["name"]:
                kernel_s[key] += (b - a) * 1e-6
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host_spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         e["name"]) for e in events
                        if e.get("cat") == "user_annotation"
                        and e["name"] in spans)
    host_ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in events
                      if e.get("cat") == "cpu_op")
    idle: dict[str, float] = {}
    for k, (a, b) in enumerate(gaps):
        if k < LABELLED_GAPS:
            label = (_covering(host_spans, (a + b) / 2, innermost=True)
                     + " / " + _covering(host_ops, (a + b) / 2,
                                         innermost=False))
        else:
            label = "other"
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return dict(window_s=(w1 - w0) * 1e-6, busy_s=busy_s, device_s=device_s,
                kernel_s=kernel_s, idle_by_host=idle)


def _covering(intervals, t: float, innermost: bool) -> str:
    """The name of the interval open at ``t``: the latest-starting one
    (innermost) or the longest one; "-" where none is."""
    i = bisect.bisect_right(intervals, (t, float("inf"), ""))
    best = None
    for a, b, name in reversed(intervals[max(0, i - 256):i]):
        if a <= t < b:
            if innermost:
                return name
            if best is None or b - a > best[0]:
                best = (b - a, name)
    return best[1] if best else "-"


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
