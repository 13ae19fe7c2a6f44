"""Linear Wagner-Fischer: banded edit distance (paper Sec. III-A, Alg. 2) —
the plain torch version of the CUDA kernel ``kernels/csrc/linear_wf.cu``.

The band has half-width ``eth``; all values saturate at ``eth + 1``.
Cell (i, j) of the WF matrix lives at band index ``d = j - i + eth``;
row ``i`` reads reference chars ``s2_window[i-1 : i-1 + 2*eth+1]``, where
``s2_window`` has length ``n + 2*eth``.

The recurrence, the int8 value arithmetic and the (min, +1) left scan
follow ``repro.core.linear_wf.banded_wf`` step for step, so the two agree
bit for bit.
"""
from __future__ import annotations

import torch


def banded_wf(s1: torch.Tensor, s2_window: torch.Tensor, eth: int = 6):
    """Batched banded WF distance. s1: (..., n), s2_window: (..., n+2*eth).

    Returns (dist_end, dist_min) int32 of shape (...): D[n][n] and the
    min over the last band row.
    """
    n = s1.shape[-1]
    band = 2 * eth + 1
    dev = s1.device
    sat = eth + 1
    d_idx = torch.arange(band, device=dev)
    lead = s1.shape[:-1]

    b0 = torch.where(d_idx < eth, sat,
                     torch.clamp(d_idx - eth, max=eth + 1)).to(torch.int8)
    prev = b0.expand(lead + (band,)).clone()
    sat8 = torch.full(lead + (1,), sat, dtype=torch.int8, device=dev)
    for i in range(1, n + 1):
        chars = s2_window[..., i - 1 : i - 1 + band]
        sub = (s1[..., i - 1 : i] != chars).to(torch.int8)
        j = i + d_idx - eth
        diag = torch.where(j >= 1, prev + sub, sat8)
        up_src = torch.cat([prev[..., 1:], sat8], dim=-1)
        up = torch.where(j >= 0, torch.clamp(up_src + 1, max=sat), sat8)
        cand = torch.clamp(torch.minimum(diag, up), max=sat)
        # left propagation: running (min, +1) scan across the band
        run = sat8[..., 0]
        cols = []
        for d in range(band):
            run = torch.minimum(cand[..., d], torch.clamp(run + 1, max=sat))
            cols.append(run)
        new = torch.stack(cols, dim=-1)
        prev = torch.where(j >= 0, new, sat8)
    return (prev[..., eth].to(torch.int32),
            prev.amin(dim=-1).to(torch.int32))
