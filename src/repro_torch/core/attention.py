"""Chunked online-softmax attention: the plain version of the flash-attention
kernels (``kernels/csrc/flash_attention.cu`` and
``flash_attention_wgmma.cu``).

It sits below both ``kernels.ops`` (whose wrapper runs it on CPU tensors)
and ``models.layers`` (which re-exports it), as the WF and minimizer
wrappers take their plain versions from this package.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

NEG = -1e30


def _sdpa_chunked(q, k, v, causal: bool, q_chunk: int = 1024,
                  kv_chunk: int = 1024, *, f32_scores: bool = False,
                  remat: bool = False):
    """Flash-style online-softmax attention: O(q_chunk * kv_chunk) live
    memory instead of O(S^2).  q (B,S,H,hd); k/v (B,S,KV,hd).

    By default the reference's chunked attention step for step (a Python
    loop where it scans): the Q.K^T and P.V products in the inputs' dtype,
    as its einsums round them.  ``f32_scores=True`` is the arithmetic of
    the Pallas body and of the Hopper kernel: q and k upcast, q scaled in
    f32, f32 scores, p rounded to v's dtype, P.V summed in f32 and the
    output rounded once.  The two coincide for float32 inputs.  Causal,
    the kv chunks that start past a query chunk's last row are skipped,
    as the reference's scan masks them whole: there every score is NEG,
    so its p is exactly 0 and its correction exactly 1, and the output is
    bit for bit the same; the other chunks are visited, and masked where
    one of their keys lies past one of the chunk's queries.

    ``remat``: each query chunk is recomputed in the backward pass instead
    of keeping its score tiles, as the reference checkpoints its
    ``q_block`` (the train step's gradient route, ``layers.attention``)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    qc = min(q_chunk, S)
    kc = min(kv_chunk, S)
    nq = S // qc
    # grouped GQA: KV never replicated across the rep query heads
    qr = q.reshape(B, nq, qc, KV, rep, hd)
    kr = k.reshape(B, S // kc, kc, KV, hd)
    vr = v.reshape(B, S // kc, kc, KV, hd)
    outs = []
    for qi in range(nq):
        args = (qr[:, qi], kr, vr, qi, causal, f32_scores)
        if remat:
            outs.append(checkpoint(_q_block, *args, use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(_q_block(*args))
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


def _q_block(qb, kr, vr, qi: int, causal: bool, f32_scores: bool):
    """Query chunk ``qi`` (B,qc,KV,rep,hd) against every kv chunk of
    ``kr``/``vr`` (B,nk,kc,KV,hd): the online softmax.  -> its output
    (B,qc,KV,rep,hd) in q's dtype."""
    B, qc, KV, rep, hd = qb.shape
    nk, kc = kr.shape[1], kr.shape[2]
    scale = 1.0 / math.sqrt(hd)
    dev = qb.device
    out_dtype = qb.dtype
    if f32_scores:
        qb = qb.float() * scale
    m = torch.full((B, KV, rep, qc), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, rep, qc), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, qc, KV, rep, hd), dtype=torch.float32, device=dev)
    # causal: kv chunks past the query chunk's last row change nothing
    last = nk if not causal else min(nk, ((qi + 1) * qc - 1) // kc + 1)
    for ki in range(last):
        kb, vb = kr[:, ki], vr[:, ki]
        if f32_scores:
            s = torch.einsum("bqgrd,bkgd->bgrqk", qb, kb.float())
        else:
            s = torch.einsum("bqgrd,bkgd->bgrqk", qb, kb).float() * scale
        if causal and (ki + 1) * kc - 1 > qi * qc:   # some key is masked
            qpos = qi * qc + torch.arange(qc, device=dev)[:, None]
            kpos = ki * kc + torch.arange(kc, device=dev)[None, :]
            s = s.masked_fill(~(qpos >= kpos), NEG)
        m_new = torch.maximum(m, s.amax(-1))               # (B,KV,rep,qc)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        p = p.to(vb.dtype)
        if f32_scores:
            pv = torch.einsum("bgrqk,bkgd->bqgrd", p.float(), vb.float())
        else:
            pv = torch.einsum("bgrqk,bkgd->bqgrd", p, vb).float()
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    # l (B,KV,rep,qc) -> (B,qc,KV,rep,1) to divide acc
    out = acc / l.permute(0, 3, 1, 2).clamp_min(1e-30)[..., None]
    return out.to(out_dtype)
