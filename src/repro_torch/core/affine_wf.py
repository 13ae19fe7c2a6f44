"""Affine Wagner-Fischer with traceback (paper Sec. III-B, Eqs. 3-5) — the
plain torch versions of the CUDA kernels ``kernels/csrc/affine_wf.cu``
and ``kernels/csrc/traceback.cu``.

Three banded matrices: D (edit distance), M1 (vertical gap, read char not
in the reference: "ins"), M2 (horizontal gap, "del"); a gap of length L
costs 1 + L.  ``eth`` is the band half-width, ``sat`` the value
saturation (defaults 6 and 32).  Packed direction byte per band cell:
``dD | dM1 << 2 | dM2 << 3`` with

  dD : 0 diag match, 1 diag substitution, 2 enter M1, 3 enter M2
  dM1: 0 extend (from M1[i-1,j]),  1 open (from D[i-1,j])
  dM2: 0 extend (from M2[i,j-1]),  1 open (from D[i,j-1])

Everything here mirrors ``repro.core.affine_wf`` bit for bit: direction
bits compare the RAW candidates and stored values are clamped to ``sat``
afterwards; off-band neighbours read ``big = sat + 40``; the j == 0 and
j < 0 columns are special-cased; values stay int8 as there.
"""
from __future__ import annotations

import torch

from .encoding import OP_DEL, OP_INS, OP_MATCH, OP_NONE, OP_SUB


def _banded_affine_impl(s1: torch.Tensor, s2_window: torch.Tensor, eth: int,
                        sat: int, emit_dirs: bool):
    n = s1.shape[-1]
    band = 2 * eth + 1
    dev = s1.device
    lead = s1.shape[:-1]
    d_idx = torch.arange(band, device=dev)
    i8 = torch.int8

    j0 = d_idx - eth
    D0 = torch.where(j0 < 0, sat, torch.clamp(
        torch.where(j0 == 0, 0, 1 + j0), max=sat))
    Dp = D0.to(i8).expand(lead + (band,)).clone()
    M1p = torch.full(lead + (band,), sat, dtype=i8, device=dev)

    sat8 = torch.full(lead, sat, dtype=i8, device=dev)
    big8 = torch.full(lead + (1,), sat + 40, dtype=i8, device=dev)
    u8 = torch.uint8
    dirs = []
    for i in range(1, n + 1):
        j = i + d_idx - eth
        chars = s2_window[..., i - 1 : i - 1 + band]
        match = s1[..., i - 1 : i] == chars

        m1_ext = torch.cat([M1p[..., 1:], big8], dim=-1) + 1   # raw
        m1_open = torch.cat([Dp[..., 1:], big8], dim=-1) + 2   # raw
        M1n = torch.clamp(torch.minimum(m1_ext, m1_open), max=sat)
        M1n = torch.where(j >= 0, M1n, sat8[..., None])
        dM1 = (m1_open < m1_ext).to(u8)

        # sequential in-row scan over the band: M2/D interdependence
        d_left = big8[..., 0]
        m2_left = big8[..., 0]
        D_cols, B_cols = [], []
        for d in range(band):
            jj = i + d - eth
            dg, m1n, mt = Dp[..., d], M1n[..., d], match[..., d]
            m2_ext = m2_left + 1     # raw
            m2_open = d_left + 2     # raw
            m2n = sat8 if jj <= 0 else torch.clamp(
                torch.minimum(m2_ext, m2_open), max=sat)
            sub_raw = dg + 1
            dmin = torch.minimum(torch.minimum(sub_raw, m1n), m2n)
            if jj < 0:
                dval = sat8
            elif jj == 0:
                dval = m1n
            else:
                dval = torch.where(mt, dg, torch.clamp(dmin, max=sat))
            if emit_dirs:
                if jj < 0:
                    byte = torch.zeros(lead, dtype=u8, device=dev)
                else:
                    if jj == 0:
                        dd = torch.full(lead, 2, dtype=u8, device=dev)
                    else:
                        dd = torch.where(
                            mt, 0, torch.where(dmin == sub_raw, 1,
                                               torch.where(dmin == m1n, 2,
                                                           3))).to(u8)
                    dm2 = (m2_open < m2_ext).to(u8)
                    byte = dd | (dM1[..., d] << 2) | (dm2 << 3)
                B_cols.append(byte)
            D_cols.append(dval)
            d_left, m2_left = dval, m2n
        Dp = torch.stack(D_cols, dim=-1)
        M1p = M1n
        if emit_dirs:
            dirs.append(torch.stack(B_cols, dim=-1))
    dist_end = Dp[..., eth].to(torch.int32)
    dist_min = Dp.amin(dim=-1).to(torch.int32)
    if not emit_dirs:
        return dist_end, dist_min, None
    return dist_end, dist_min, torch.stack(dirs, dim=-2)


def banded_affine(s1: torch.Tensor, s2_window: torch.Tensor, eth: int = 6,
                  sat: int = 32):
    """Batched banded affine WF.  s1: (..., n), s2_window: (..., n + 2*eth).

    Returns (dist_end, dist_min, dirs) with dirs (..., n, 2*eth+1) uint8
    packed direction bytes.  int8 value arithmetic saturated at ``sat``.
    """
    return _banded_affine_impl(s1, s2_window, eth, sat, emit_dirs=True)


def banded_affine_dist(s1: torch.Tensor, s2_window: torch.Tensor,
                       eth: int = 6, sat: int = 32):
    """Distance-only banded affine WF: ``banded_affine`` without the
    direction planes.  Returns (dist_end, dist_min) int32."""
    de, dm, _ = _banded_affine_impl(s1, s2_window, eth, sat,
                                    emit_dirs=False)
    return de, dm


def traceback_step(i, d, state, byte, eth: int):
    """One fused-transition traceback step (``repro.core.affine_wf
    .traceback_step``): an "enter M1/M2" transition (dd == 2/3) is fused
    with the gap move it precedes, so every step emits exactly one op and
    step t IS op index t for every still-active walk.

    All args are int tensors of one broadcastable shape (``byte`` is the
    packed direction byte at (i-1, d)).  Returns (op, ni, nd, ns, active);
    outputs for inactive walks are unmasked — callers apply ``active``.
    """
    j = i + d - eth
    active = (i > 0) | (j > 0)
    dd, dm1, dm2 = byte & 3, (byte >> 2) & 1, (byte >> 3) & 1
    top = i == 0                      # top row: horizontal to (0,0)
    left = (j == 0) & ~top            # left col: vertical, state preserved
    in_d = (state == 0) & ~top & ~left
    go_m1 = ((state == 1) & ~top & ~left) | (in_d & (dd == 2))
    go_m2 = ((state == 2) & ~top & ~left) | (in_d & (dd == 3))
    diag = in_d & (dd <= 1)
    vert = left | go_m1
    op = torch.where(diag, torch.where(dd == 0, OP_MATCH, OP_SUB),
                     torch.where(vert, OP_INS, OP_DEL))
    ni = torch.where(diag | vert, i - 1, i)
    nd = torch.where(vert, d + 1, torch.where(top | go_m2, d - 1, d))
    ns = torch.where(go_m1, torch.where(dm1 == 1, 0, 1),
                     torch.where(go_m2, torch.where(dm2 == 1, 0, 2), state))
    return op, ni, nd, ns, active


def traceback(dirs: torch.Tensor, eth: int, max_ops: int | None = None):
    """Batched traceback walk.  dirs: (..., n, band) -> ops (..., max_ops)
    int32 filled from the END (left-padded with OP_NONE), plus the op
    count (...,) int32.

    The k-th op of every walk lands in row ``(max_ops - 1 - k) % max_ops``;
    with a ``max_ops`` shorter than the walk, later ops overwrite earlier
    ones exactly as the reference does.
    """
    n, band = dirs.shape[-2], dirs.shape[-1]
    if max_ops is None:
        max_ops = 2 * n + 2
    lead = dirs.shape[:-2]
    flat = dirs.reshape(-1, n * band).to(torch.int64)
    R = flat.shape[0]
    dev = dirs.device
    i = torch.full((R,), n, dtype=torch.int64, device=dev)
    d = torch.full((R,), eth, dtype=torch.int64, device=dev)
    state = torch.zeros(R, dtype=torch.int64, device=dev)
    k = torch.zeros(R, dtype=torch.int32, device=dev)
    ops = torch.full((max_ops, R), OP_NONE, dtype=torch.int32, device=dev)
    t = 0
    while bool(((i > 0) | (i + d - eth > 0)).any()):
        cell = (torch.clamp(i - 1, min=0) * band + d).clamp(0, n * band - 1)
        byte = flat.gather(1, cell[:, None])[:, 0]
        op, ni, nd, ns, active = traceback_step(i, d, state, byte, eth)
        i = torch.where(active, ni, i)
        d = torch.where(active, nd, d)
        state = torch.where(active, ns, state)
        row = (max_ops - 1 - t) % max_ops
        ops[row] = torch.where(active, op.to(torch.int32), ops[row])
        k += active.to(torch.int32)
        t += 1
    return ops.T.reshape(lead + (max_ops,)), k.reshape(lead)
