"""State-space blocks on torch tensors: Mamba-1 (falcon-mamba) and Mamba-2 /
SSD (zamba2) — the reference's ``models/ssm.py``, name for name.

The prefill path cuts the sequence into chunks of ``cfg.ssm_chunk``.
Within a chunk Mamba-1 runs an associative scan over (decay, input)
pairs and Mamba-2 the SSD matmul form (decay-masked (C·B^T) products);
the chunks are chained by the (B, heads/channels, state) SSM state.  The
work inside a chunk does not depend on the state it starts from, so it
runs for a group of chunks at once (``_SSM_GROUP_ELEMS`` bounds a group's
largest tensor); only the state's hand-over runs chunk by chunk.

The decode path carries (ssm_state, conv_state) per layer: O(1) per token.

On DTensors (a ``Shardings`` mesh) the in- and out-projections keep the
weights' sharding and the mixer between them (the convolution, the scans,
the gating) runs whole on each rank (``layers.on_replicated``): DTensor
has no rule for the scans' strided passes.
"""
from __future__ import annotations

import math

import torch

from .layers import (NO_SHARD, Shardings, _mm, _normal, _silu, compute_dtype,
                     on_replicated, rms_norm)

# elements of a chunk group's largest f32 tensor (1 GiB)
_SSM_GROUP_ELEMS = 1 << 28


def _softplus(x):
    """``jax.nn.softplus`` as XLA computes it: logaddexp(x, 0) =
    max(x, 0) + log1p(exp(-|x|)) (``F.softplus`` takes another form)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv, window K.  x (B, S, C), w (K, C), b (C,).

    If conv_state (B, K-1, C) is given (decode), it prefixes x and the new
    state is returned."""
    K = w.shape[0]
    if conv_state is None:
        pad = torch.zeros(x.shape[:1] + (K - 1,) + x.shape[2:],
                          dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    wc = compute_dtype(w)
    y = sum(xp[:, i : i + x.shape[1]] * wc[i] for i in range(K))
    y = y + compute_dtype(b)
    new_state = xp[:, -(K - 1) :] if K > 1 else None
    return y, new_state


def _group(n_chunks: int, per_chunk: int) -> int:
    """Chunks a group holds when one chunk's largest tensor has
    ``per_chunk`` elements."""
    return max(1, min(n_chunks, _SSM_GROUP_ELEMS // max(per_chunk, 1)))


# ===================================================================== Mamba-1
def init_mamba1(generator, cfg, device=None):
    d, di, N = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    dtr = cfg.ssm_dt_rank
    K = cfg.ssm_conv
    s = 1.0 / math.sqrt(d)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _normal(generator, (d, 2 * di), device) * s,
        "conv_w": _normal(generator, (K, di), device) * 0.1,
        "conv_b": torch.zeros((di,), **f32),
        "x_proj": _normal(generator, (di, dtr + 2 * N), device)
        / math.sqrt(di),
        "dt_proj": _normal(generator, (dtr, di), device) / math.sqrt(dtr),
        "dt_bias": torch.full((di,), -4.6, **f32),   # softplus ~ 0.01
        "A_log": torch.log(torch.arange(1, N + 1, **f32)).expand(
            di, N).contiguous(),
        "D": torch.ones((di,), **f32),
        "out_proj": _normal(generator, (di, d), device) / math.sqrt(di),
    }


def _combine(l, r):
    """(a_l, b_l) then (a_r, b_r): h -> a_r (a_l h + b_l) + b_r."""
    al, bl = l
    ar, br = r
    return al * ar, br + ar * bl


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along dim 1 (len(even) - len(odd) is
    0 or 1)."""
    out = torch.empty((even.shape[0], even.shape[1] + odd.shape[1])
                      + even.shape[2:], dtype=even.dtype, device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a, b):
    """Inclusive scan of ``_combine`` along dim 1, with the combine tree of
    ``jax.lax.associative_scan`` (adjacent pairs reduced, the odd
    positions scanned recursively, the even ones combined from them), so
    the f32 products and sums are the reference's, in its order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _mamba1_scan_chunk(h_in, a, bx):
    """Associative scan within a chunk.  a, bx (B, C, di, N); h_in (B, di, N).

    h_t = a_t * h_{t-1} + bx_t.  Returns (h_all (B,C,di,N), h_out)."""
    a_c, b_c = _associative_scan(a, bx)
    h_all = a_c * h_in[:, None] + b_c
    return h_all, h_all[:, -1]


_PROJ = ("in_proj", "out_proj")


def _mixed(fn, xz, p, cfg, *state):
    """``fn(xz, p, cfg, *state)``, the block between its projections, on
    ``layers.on_replicated`` with the block's other weights."""
    names = [k for k in p if k not in _PROJ]
    return on_replicated(
        lambda xz, *ws: fn(xz, dict(zip(names, ws[:len(names)])), cfg,
                           *ws[len(names):]),
        xz, *(p[k] for k in names), *state)


def mamba1_block(x, p, cfg, *, sh: Shardings = NO_SHARD):
    """Prefill forward.  x (B, S, D) -> (B, S, D)."""
    C = min(cfg.ssm_chunk, x.shape[1])
    if x.shape[1] % C:
        raise ValueError(f"S={x.shape[1]} is not a multiple of "
                         f"ssm_chunk={C}")
    xz = _mm(x, compute_dtype(p["in_proj"]))
    xz = sh.constrain(xz, sh.batch, None, sh.model)
    y = _mixed(_mamba1_mix, xz, p, cfg)
    y = sh.constrain(y, sh.batch, None, sh.model)
    return sh.constrain(_mm(y, compute_dtype(p["out_proj"])), sh.batch,
                        None, None)


def _mamba1_mix(xz, p, cfg):
    """Mamba-1 from the in-projection's output (B, S, 2*di) to the
    out-projection's input (B, S, di)."""
    B, S, _ = xz.shape
    di, N, dtr = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_dt_rank
    C = min(cfg.ssm_chunk, S)
    xin, z = torch.chunk(xz, 2, dim=-1)
    xin, _ = _causal_conv(xin, p["conv_w"], p["conv_b"])
    xin = _silu(xin)
    dbc = _mm(xin, compute_dtype(p["x_proj"]))
    dt_in, Bm, Cm = torch.tensor_split(dbc, [dtr, dtr + N], dim=-1)
    dt = _softplus(_mm(dt_in, compute_dtype(p["dt_proj"])).float()
                   + p["dt_bias"])                          # (B,S,di) f32
    A = -torch.exp(p["A_log"])                              # (di, N)

    nc = S // C
    G = _group(nc, B * C * di * N)
    h = torch.zeros((B, di, N), dtype=torch.float32, device=xz.device)
    ys = []
    for g0 in range(0, nc, G):
        g1 = min(g0 + G, nc)
        n = g1 - g0
        sl = slice(g0 * C, g1 * C)
        # the group's chunks as batch rows: (n*B, C, ...), chunk-major
        xc = xin[:, sl].float().reshape(B, n, C, di).transpose(0, 1)
        dtc = dt[:, sl].reshape(B, n, C, di).transpose(0, 1)
        bc = Bm[:, sl].float().reshape(B, n, C, N).transpose(0, 1)
        cc = Cm[:, sl].float().reshape(B, n, C, N).transpose(0, 1)
        a = torch.exp(dtc[..., None] * A)                   # (n,B,C,di,N)
        bx = (dtc * xc)[..., None] * bc[:, :, :, None, :]
        a_c, b_c = _associative_scan(a.flatten(0, 1), bx.flatten(0, 1))
        a_c = a_c.unflatten(0, (n, B))
        b_c = b_c.unflatten(0, (n, B))
        del a, bx
        # each chunk's starting state, then its states all at once
        h_in = []
        for j in range(n):
            h_in.append(h)
            h = a_c[j, :, -1] * h + b_c[j, :, -1]
        h_all = a_c * torch.stack(h_in)[:, :, None] + b_c   # (n,B,C,di,N)
        del a_c, b_c
        y = torch.einsum("gbcdn,gbcn->gbcd", h_all, cc)     # (n,B,C,di)
        ys.append(y.transpose(0, 1).reshape(B, n * C, di))
        del h_all
    y = torch.cat(ys, dim=1).to(xz.dtype)
    y = y + xin * compute_dtype(p["D"])
    return y * _silu(z)


def mamba1_decode(x, p, cfg, state, *, sh: Shardings = NO_SHARD):
    """x (B, 1, D); state {"h": (B,di,N) f32, "conv": (B,K-1,di)}.
    -> (out, new state)."""
    xz = _mm(x, compute_dtype(p["in_proj"]))
    y, h, conv = _mixed(_mamba1_step, xz, p, cfg, state["h"], state["conv"])
    out = _mm(y, compute_dtype(p["out_proj"]))
    return sh.constrain(out, sh.batch, None, None), {"h": h, "conv": conv}


def _mamba1_step(xz, p, cfg, h, conv):
    """One Mamba-1 decode step between the projections -> (y, h, conv)."""
    di, N, dtr = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_dt_rank
    xin, z = torch.chunk(xz, 2, dim=-1)
    xin, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"], conv)
    xin = _silu(xin)
    dbc = _mm(xin, compute_dtype(p["x_proj"]))
    dt_in, Bm, Cm = torch.tensor_split(dbc, [dtr, dtr + N], dim=-1)
    dt = _softplus(_mm(dt_in, compute_dtype(p["dt_proj"])).float()
                   + p["dt_bias"])[:, 0]                    # (B, di)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[..., None] * A)                        # (B,di,N)
    bx = (dt * xin[:, 0].float())[..., None] * Bm[:, 0].float()[:, None, :]
    h = a * h + bx
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float())
    y = y[:, None].to(xz.dtype) + xin * compute_dtype(p["D"])
    return y * _silu(z), h, conv_state


def init_mamba1_state(cfg, batch: int, device=None):
    return {"h": torch.zeros((batch, cfg.ssm_d_inner, cfg.ssm_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.ssm_d_inner),
                                dtype=torch.bfloat16, device=device)}


# ===================================================================== Mamba-2
def init_mamba2(generator, cfg, device=None):
    d, di, N = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    H = cfg.ssm_heads
    K = cfg.ssm_conv
    s = 1.0 / math.sqrt(d)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # [x, z, B, C, dt]
        "in_proj": _normal(generator, (d, 2 * di + 2 * N + H), device) * s,
        "conv_w": _normal(generator, (K, di + 2 * N), device) * 0.1,
        "conv_b": torch.zeros((di + 2 * N,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "A_log": torch.zeros((H,), **f32),
        "D": torch.ones((H,), **f32),
        "norm_scale": torch.ones((di,), **f32),
        "out_proj": _normal(generator, (di, d), device) / math.sqrt(di),
    }


def mamba2_block(x, p, cfg, *, sh: Shardings = NO_SHARD):
    """SSD chunked forward.  x (B, S, D) -> (B, S, D) (``_mamba2_mix``)."""
    C = min(cfg.ssm_chunk, x.shape[1])
    if x.shape[1] % C:
        raise ValueError(f"S={x.shape[1]} is not a multiple of "
                         f"ssm_chunk={C}")
    proj = _mm(x, compute_dtype(p["in_proj"]))
    y = _mixed(_mamba2_mix, proj, p, cfg)
    y = sh.constrain(y, sh.batch, None, sh.model)
    return sh.constrain(_mm(y, compute_dtype(p["out_proj"])), sh.batch,
                        None, None)


def _mamba2_mix(proj, p, cfg):
    """Mamba-2 (SSD) from the in-projection's output to the
    out-projection's input (B, S, di).

    Within a chunk, y_t = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s
    x_s + C_t . exp(cum_t) h_in.  The decay is masked to s <= t before
    the exponential: the reference takes exp of every (t, s) and masks
    the product after, which overflows to inf * 0 = NaN once a chunk's
    log-decay passes about 88 (at ssm_chunk=128 and dt near 0.7); where
    the reference is finite the two are equal."""
    B, S, _ = proj.shape
    di, N, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    P = di // H
    C = min(cfg.ssm_chunk, S)
    xin, z, Bm, Cm, dt_in = torch.tensor_split(
        proj, [di, 2 * di, 2 * di + N, 2 * di + 2 * N], dim=-1)
    xbc = torch.cat([xin, Bm, Cm], dim=-1)
    xbc, _ = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xbc = _silu(xbc)
    xin, Bm, Cm = torch.tensor_split(xbc, [di, di + N], dim=-1)
    dt = _softplus(dt_in.float() + p["dt_bias"])            # (B,S,H)
    A = -torch.exp(p["A_log"])                              # (H,)
    la = dt * A                                             # log-decay

    nc = S // C
    G = _group(nc, B * C * C * H)
    tri = torch.ones((C, C), dtype=torch.bool, device=proj.device).tril()
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=proj.device)
    ys = []
    for g0 in range(0, nc, G):
        g1 = min(g0 + G, nc)
        n = g1 - g0
        sl = slice(g0 * C, g1 * C)
        xc = xin[:, sl].float().reshape(B, n, C, H, P)
        dtk = dt[:, sl].reshape(B, n, C, H)
        bk = Bm[:, sl].float().reshape(B, n, C, N)
        ck = Cm[:, sl].float().reshape(B, n, C, N)
        cum = torch.cumsum(la[:, sl].reshape(B, n, C, H), dim=2)
        # intra-chunk: att[t,s] = (C_t . B_s) exp(cum_t - cum_s) dt_s, s<=t
        cb = torch.einsum("bgtn,bgsn->bgts", ck, bk)        # (B,n,C,C)
        gap = cum[:, :, :, None] - cum[:, :, None]          # (B,n,t,s,H)
        decay = torch.exp(gap.masked_fill(~tri[:, :, None], -math.inf))
        del gap
        att = cb[..., None] * decay * dtk[:, :, None]       # (B,n,t,s,H)
        del decay, cb
        y = torch.einsum("bgtsh,bgshp->bgthp", att, xc)     # (B,n,C,H,P)
        del att
        # the chunks' states: tot the chunk's log-decay, hb its inputs'
        tot = cum[:, :, -1]                                  # (B,n,H)
        w = torch.exp(tot[:, :, None] - cum) * dtk           # (B,n,C,H)
        hb = torch.einsum("bgshp,bgsn->bghpn", w[..., None] * xc, bk)
        h_in = []
        for j in range(n):
            h_in.append(h)
            h = torch.exp(tot[:, j])[:, :, None, None] * h + hb[:, j]
        # inter-chunk: y_t += C_t . (exp(cum_t) h_in)
        y = y + torch.einsum("bgtn,bghpn->bgthp", ck, torch.stack(
            h_in, dim=1)) * torch.exp(cum)[..., None]
        ys.append(y.reshape(B, n * C, di))
    y = torch.cat(ys, dim=1).to(proj.dtype)
    y = y + xin * torch.repeat_interleave(compute_dtype(p["D"]), P)
    return rms_norm(y * _silu(z), p["norm_scale"])


def mamba2_decode(x, p, cfg, state, *, sh: Shardings = NO_SHARD):
    """x (B,1,D); state {"h": (B,H,P,N) f32, "conv": (B,K-1,di+2N)}.
    -> (out, new state)."""
    proj = _mm(x, compute_dtype(p["in_proj"]))
    y, h, conv = _mixed(_mamba2_step, proj, p, cfg, state["h"],
                        state["conv"])
    out = _mm(y, compute_dtype(p["out_proj"]))
    return sh.constrain(out, sh.batch, None, None), {"h": h, "conv": conv}


def _mamba2_step(proj, p, cfg, h, conv):
    """One Mamba-2 decode step between the projections -> (y, h, conv)."""
    B = proj.shape[0]
    di, N, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    P = di // H
    xin, z, Bm, Cm, dt_in = torch.tensor_split(
        proj, [di, 2 * di, 2 * di + N, 2 * di + 2 * N], dim=-1)
    xbc = torch.cat([xin, Bm, Cm], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv)
    xbc = _silu(xbc)
    xin, Bm, Cm = torch.tensor_split(xbc, [di, di + N], dim=-1)
    dt = _softplus(dt_in[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)                                   # (B,H)
    xh = xin[:, 0].reshape(B, H, P).float()
    hb = torch.einsum("bh,bn,bhp->bhpn", dt, Bm[:, 0].float(), xh)
    h = a[:, :, None, None] * h + hb
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), h)
    y = y.reshape(B, 1, di).to(proj.dtype)
    y = y + xin * torch.repeat_interleave(compute_dtype(p["D"]), P)
    return rms_norm(y * _silu(z), p["norm_scale"]), h, conv_state


def init_mamba2_state(cfg, batch: int, device=None):
    H, P = cfg.ssm_heads, cfg.ssm_d_inner // cfg.ssm_heads
    return {"h": torch.zeros((batch, H, P, cfg.ssm_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros(
                (batch, cfg.ssm_conv - 1, cfg.ssm_d_inner + 2 * cfg.ssm_state),
                dtype=torch.bfloat16, device=device)}
