"""The sharded index's routing hash on the host — ``np_hash32`` of
``repro.index.npscan``, a bit-identical numpy twin of
``core.minimizers.hash32`` on uint32 arrays.

A k-mer's partition is ``hash32(kmer) % P``: the build spills each
occurrence by it, routed seeding sends each read minimizer by it.  The
minimizer scans themselves (the build's tiles, routed seeding's reads)
go through ``core.minimizers`` and ``core.wf_backend``: the kernel on
``"cuda"``, the plain torch version on ``"torch"`` or the CPU.
"""
from __future__ import annotations

import numpy as np


def np_hash32(x: np.ndarray) -> np.ndarray:
    """Invertible 32-bit integer mix — ``core.minimizers.hash32`` twin."""
    x = np.asarray(x, dtype=np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))
