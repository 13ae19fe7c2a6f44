"""Chunked online-softmax attention: the plain version of the flash-attention
kernel (``kernels/csrc/flash_attention.cu``).

It sits below both ``kernels.ops`` (whose wrapper runs it on CPU tensors)
and ``models.layers`` (which re-exports it), as the WF and minimizer
wrappers take their plain versions from this package.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def _sdpa_chunked(q, k, v, causal: bool, q_chunk: int = 1024,
                  kv_chunk: int = 1024, *, f32_scores: bool = False):
    """Flash-style online-softmax attention: O(q_chunk * kv_chunk) live
    memory instead of O(S^2).  q (B,S,H,hd); k/v (B,S,KV,hd).

    By default the reference's chunked attention step for step (a Python
    loop where it scans): the Q.K^T and P.V products in the inputs' dtype,
    as its einsums round them.  ``f32_scores=True`` is the arithmetic of
    the Pallas body and of the Hopper kernel: q and k upcast, q scaled in
    f32, f32 scores, p rounded to v's dtype, P.V summed in f32 and the
    output rounded once.  The two coincide for float32 inputs.  Every kv
    chunk is visited and causal ones are masked."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    qc = min(q_chunk, S)
    kc = min(kv_chunk, S)
    nq, nk = S // qc, S // kc
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    # grouped GQA: KV never replicated across the rep query heads
    qr = q.reshape(B, nq, qc, KV, rep, hd)
    kr = k.reshape(B, nk, kc, KV, hd)
    vr = v.reshape(B, nk, kc, KV, hd)
    outs = []
    for qi in range(nq):
        qb = qr[:, qi]                                     # (B,qc,KV,rep,hd)
        if f32_scores:
            qb = qb.float() * scale
        m = torch.full((B, KV, rep, qc), NEG, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, rep, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, qc, KV, rep, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kb, vb = kr[:, ki], vr[:, ki]
            if f32_scores:
                s = torch.einsum("bqgrd,bkgd->bgrqk", qb, kb.float())
            else:
                s = torch.einsum("bqgrd,bkgd->bgrqk", qb, kb).float() * scale
            if causal:
                qpos = qi * qc + torch.arange(qc, device=dev)[:, None]
                kpos = ki * kc + torch.arange(kc, device=dev)[None, :]
                s = s.masked_fill(~(qpos >= kpos), NEG)
            m_new = torch.maximum(m, s.amax(-1))           # (B,KV,rep,qc)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            p = p.to(v.dtype)
            if f32_scores:
                pv = torch.einsum("bgrqk,bkgd->bqgrd", p.float(), vb.float())
            else:
                pv = torch.einsum("bgrqk,bkgd->bqgrd", p, vb).float()
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        # l (B,KV,rep,qc) -> (B,qc,KV,rep,1) to divide acc
        out = acc / l.permute(0, 3, 1, 2).clamp_min(1e-30)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)
