"""Field-by-field comparison of the program's results with the reference's,
shared by the entries."""
from __future__ import annotations

import numpy as np

# mapping fields compared for every kept read
READ_FIELDS = ("position", "distance", "distance2", "mapped", "strand",
               "n_candidates", "op_count", "ops", "linear_dist")


def fields(res, rows, names=READ_FIELDS) -> dict:
    """The compared fields of a MappingResult at ``rows`` (missing fields
    are left out; ``linear_dist`` only where the engine returns it)."""
    out = {}
    for k in names:
        v = getattr(res, k)
        if v is not None:
            out[k] = np.asarray(v)[rows]
    return out


def mismatched(got: dict, want: dict, names=READ_FIELDS) -> int:
    """Rows on which any field present in ``got`` differs from ``want``."""
    n = len(next(iter(got.values())))
    bad = np.zeros(n, bool)
    for f in names:
        if f not in got:
            continue
        a, b = np.asarray(got[f]), np.asarray(want[f])
        if a.shape != b.shape:
            return n
        bad |= (a != b).reshape(n, -1).any(axis=1)
    return int(bad.sum())


def concat(parts: list) -> dict:
    """Dicts of arrays (or of dicts of arrays) joined along their rows."""
    out = {}
    for key in parts[0]:
        if isinstance(parts[0][key], dict):
            out[key] = {f: np.concatenate([p[key][f] for p in parts])
                        for f in parts[0][key]}
        else:
            out[key] = np.concatenate([p[key] for p in parts])
    return out


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The run's host generator for one named stream."""
    return np.random.default_rng([int(seed) % (1 << 63), *stream])
