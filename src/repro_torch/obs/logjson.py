"""Structured JSON logging for the launchers (``--log-json``) — a copy of
``repro.obs.logjson``.

One JSON object per line on the configured stream (stderr by default),
so launcher progress/closing output becomes machine-parseable without
scraping the human-readable lines.  Disabled by default; the launchers'
``say`` calls fall back to plain ``print`` when not enabled, keeping
the human output byte-identical to before this layer existed.
"""
from __future__ import annotations

import json
import sys
import time

__all__ = ["enable", "disable", "enabled", "emit", "say"]

_state = {"stream": None, "component": None}


def enable(component: str, stream=None) -> None:
    _state["component"] = component
    _state["stream"] = stream if stream is not None else sys.stderr


def disable() -> None:
    _state["stream"] = None
    _state["component"] = None


def enabled() -> bool:
    return _state["stream"] is not None


def emit(event: str, **fields) -> bool:
    """Write one JSON log line; returns False (and writes nothing) when
    JSON logging is not enabled, so callers can fall back to print."""
    stream = _state["stream"]
    if stream is None:
        return False
    rec = {"ts_unix_s": time.time(), "component": _state["component"],
           "event": event}
    rec.update(fields)
    stream.write(json.dumps(rec, default=str) + "\n")
    stream.flush()
    return True


def say(msg: str, *, event: str = "log", file=None, **fields) -> None:
    """JSON log line when enabled, else a plain print to ``file``
    (stderr by default) — the launchers' one-call progress surface."""
    if not emit(event, msg=msg, **fields):
        print(msg, file=file if file is not None else sys.stderr)
