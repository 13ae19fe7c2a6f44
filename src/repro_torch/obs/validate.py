"""Dependency-free validators for the exported observability artifacts (a
copy of ``repro.obs.validate``).

Two consumers: ``chip_smoke.py`` (which must validate without
installing ``jsonschema``) and the test suite.  ``validate_chrome_trace``
checks the Chrome trace-event contract Perfetto relies on — every
complete ("X") span carries numeric pid/tid/ts/dur, and any duration
("B"/"E") events balance per (pid, tid) track.  ``validate_json`` is a
minimal JSON-Schema-subset checker (type / required / properties /
additionalProperties / items / enum / minimum) — enough to hold the
metrics-JSONL snapshot format to ``schemas/metrics_snapshot.schema.json``
without a schema library.
"""
from __future__ import annotations

import json

__all__ = ["validate_chrome_trace", "validate_json", "validate_jsonl",
           "load_json"]

_NUM = (int, float)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def validate_chrome_trace(trace) -> list[str]:
    """-> list of violations (empty = valid).  Accepts the object form
    (``{"traceEvents": [...]}``) or the bare event array."""
    errors: list[str] = []
    events = (trace.get("traceEvents") if isinstance(trace, dict)
              else trace)
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    if not events:
        errors.append("trace holds no events")
    stacks: dict[tuple, list] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph is None:
            errors.append(f"event {i}: missing ph")
            continue
        where = f"event {i} ({ev.get('name', '?')!r}, ph={ph})"
        if ph == "M":
            if "name" not in ev or "pid" not in ev:
                errors.append(f"{where}: metadata needs name and pid")
            continue
        for field in ("name", "pid", "tid", "ts"):
            if field not in ev:
                errors.append(f"{where}: missing {field}")
        for field in ("pid", "tid", "ts"):
            if field in ev and not isinstance(ev[field], _NUM):
                errors.append(f"{where}: {field} is not numeric")
        if ph == "X":
            if "dur" not in ev:
                errors.append(f"{where}: complete event missing dur")
            elif not isinstance(ev["dur"], _NUM):
                errors.append(f"{where}: dur is not numeric")
            elif ev["dur"] < 0:
                errors.append(f"{where}: negative dur")
        elif ph == "B":
            stacks.setdefault((ev.get("pid"), ev.get("tid")),
                              []).append(ev.get("name"))
        elif ph == "E":
            stack = stacks.get((ev.get("pid"), ev.get("tid")))
            if not stack:
                errors.append(f"{where}: E without matching B on its "
                              f"(pid, tid) track")
            else:
                stack.pop()
    for (pid, tid), stack in stacks.items():
        for name in stack:
            errors.append(f"unbalanced B event {name!r} on track "
                          f"(pid={pid}, tid={tid}): no matching E")
    return errors


def validate_json(obj, schema: dict, path: str = "$") -> list[str]:
    """Check ``obj`` against a JSON-Schema subset; -> violations."""
    errors: list[str] = []
    t = schema.get("type")
    if t is not None:
        ok = {"object": lambda o: isinstance(o, dict),
              "array": lambda o: isinstance(o, list),
              "string": lambda o: isinstance(o, str),
              "number": lambda o: isinstance(o, _NUM)
              and not isinstance(o, bool),
              "integer": lambda o: isinstance(o, int)
              and not isinstance(o, bool),
              "boolean": lambda o: isinstance(o, bool),
              "null": lambda o: o is None}
        types = t if isinstance(t, list) else [t]
        if not any(ok[x](obj) for x in types):
            return [f"{path}: expected {t}, got {type(obj).__name__}"]
    if "enum" in schema and obj not in schema["enum"]:
        errors.append(f"{path}: {obj!r} not in enum {schema['enum']}")
    if "minimum" in schema and isinstance(obj, _NUM) \
            and obj < schema["minimum"]:
        errors.append(f"{path}: {obj} < minimum {schema['minimum']}")
    if isinstance(obj, dict):
        for req in schema.get("required", ()):
            if req not in obj:
                errors.append(f"{path}: missing required key {req!r}")
        props = schema.get("properties", {})
        extra = schema.get("additionalProperties")
        for k, v in obj.items():
            if k in props:
                errors += validate_json(v, props[k], f"{path}.{k}")
            elif isinstance(extra, dict):
                errors += validate_json(v, extra, f"{path}.{k}")
            elif extra is False:
                errors.append(f"{path}: unexpected key {k!r}")
    if isinstance(obj, list) and "items" in schema:
        for i, v in enumerate(obj):
            errors += validate_json(v, schema["items"], f"{path}[{i}]")
    return errors


def validate_jsonl(path: str, schema: dict) -> list[str]:
    """Validate every line of a JSONL file against ``schema``."""
    errors: list[str] = []
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            n += 1
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {lineno}: not JSON ({e})")
                continue
            errors += validate_json(obj, schema, path=f"line {lineno}")
    if n == 0:
        errors.append("no JSONL records")
    return errors
