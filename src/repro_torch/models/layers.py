"""Transformer building blocks on torch tensors: the reference's
``models/layers.py``, name for name (norms, RoPE, attention, MLP, MoE).

Conventions, as in the reference:
  * params are plain dicts of tensors; fp32 storage, bf16 compute;
  * attention supports GQA, RoPE (with a position offset for decode),
    optional qk-norm (Qwen3), causal/bidirectional, and a KV-cache decode
    path (bf16 or int8 cache).

The reference's ``Shardings`` argument is dropped: without a mesh it does
nothing.  Long-sequence attention (S > ``ATTN_CHUNK_THRESHOLD``) runs
``kernels.ops.flash_attention``: on CUDA tensors the Hopper kernel, on CPU
tensors ``_sdpa_chunked`` (``core.attention``, re-exported here), which is
the kernel's plain version and computes what the reference computes there.
With gradients on, it takes the gradient route instead (``attention``).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from ..core.attention import NEG, _sdpa_chunked  # noqa: F401
from ..kernels import ops


def compute_dtype(x):
    return x.to(torch.bfloat16)


def _mm(x, w):
    """x @ w for bf16 operands, accumulated in f32 and rounded once, as XLA
    and cuBLAS compute it.  torch's CPU bf16 matmul rounds elsewhere, so
    on the CPU the product is taken in f32 and rounded."""
    if x.is_cuda:
        return x @ w
    return (x.float() @ w.float()).to(torch.promote_types(x.dtype, w.dtype))


def _silu(x):
    """x * sigmoid(x) op by op in x's dtype, as the reference's
    ``jax.nn.silu`` rounds it (``F.silu`` rounds once)."""
    return x * (1 / (1 + torch.exp(-x)))


# ----------------------------------------------------------------- norms
def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x, scale=None, bias=None, eps: float = 1e-5):
    """LayerNorm; scale/bias may be None (OLMo's non-parametric LN)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def apply_norm(x, p, kind: str):
    if kind == "rms":
        return rms_norm(x, p["scale"])
    if kind == "ln":
        return layer_norm(x, p.get("scale"), p.get("bias"))
    if kind == "ln_nonparam":
        return layer_norm(x, None, None)
    raise ValueError(kind)


def init_norm(generator, d, kind: str, device=None):
    if kind == "ln_nonparam":
        return {}
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


# ----------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x (..., S, H, hd); positions (..., S) int32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)          # (hd/2,)
    ang = positions[..., None].float() * freqs       # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : hd // 2].float(), x[..., hd // 2 :].float()
    return torch.cat([xf1 * cos - xf2 * sin,
                      xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# ----------------------------------------------------------------- attention
def _normal(generator, shape, device):
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


def init_attention(generator, cfg, device=None):
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(generator, (d, nh * hd), device) * s,
        "wk": _normal(generator, (d, nkv * hd), device) * s,
        "wv": _normal(generator, (d, nkv * hd), device) * s,
        "wo": _normal(generator, (nh * hd, d), device) * s,
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
    return p


def _qkv(x, p, cfg, positions):
    B, S, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _mm(x, compute_dtype(p["wq"])).reshape(B, S, nh, hd)
    k = _mm(x, compute_dtype(p["wk"])).reshape(B, S, nkv, hd)
    v = _mm(x, compute_dtype(p["wv"])).reshape(B, S, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, causal: bool, q_offset=None):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) -> (B,Sq,H,hd).

    GQA via grouped einsum — the KV tensors are never replicated across the
    query-head group."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    qg = q.reshape(B, Sq, KV, rep, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float()
    logits = logits * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (
            0 if q_offset is None else q_offset)
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = logits.masked_fill(~(qi >= ki), NEG)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w, v)
    return out.reshape(B, Sq, H, hd)


ATTN_CHUNK_THRESHOLD = 2048


def attention(x, p, cfg, positions=None, causal=True):
    """Full (training / prefill) attention. x (B, S, D)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    q, k, v = _qkv(x, p, cfg, positions)
    if S > ATTN_CHUNK_THRESHOLD and torch.is_grad_enabled() and \
            q.requires_grad:
        # the gradient route: the kernels have no backward, so the layer
        # differentiates the function the reference differentiates, its
        # chunked attention, each query chunk recomputed in the backward
        o = _sdpa_chunked(q, k, v, causal, 1024, 1024, remat=True)
    elif S > ATTN_CHUNK_THRESHOLD:
        o = ops.flash_attention(q, k, v, causal=causal, q_chunk=1024,
                                kv_chunk=1024)
    else:
        o = _sdpa(q, k, v, causal)
    o = o.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return _mm(o, compute_dtype(p["wo"]))


def _quant(x):
    """Per-(token, kv-head) symmetric int8 quantization -> (int8, f32
    scale (..., 1))."""
    s = x.float().abs().amax(-1, keepdim=True) / 127.0 + 1e-12
    return torch.round(x.float() / s).to(torch.int8), s


def decode_attention(x, p, cfg, cache, pos: int, *,
                     seq_shard_axes: Sequence[str] = ()):
    """One-token decode with KV cache.

    x (B, 1, D); cache dict {k, v: (B, S_max, KV, hd)} (bf16), or int8
    k/v with f32 ``k_scale``/``v_scale`` (B, S_max, KV, 1).  Row ``pos``
    of the cache is written in place (the reference returns an updated
    copy); the returned cache holds the same tensors.
    """
    if seq_shard_axes:
        raise NotImplementedError(
            "sequence-sharded KV cache (distributed flash-decode) needs the "
            "production mesh: ROADMAP Queue 1 item 11")
    B = x.shape[0]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(x, p, cfg, positions)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cache["k"].dtype == torch.int8:
        # int8 KV cache: dequantization is folded into the attention
        # einsums — the cache is never materialized in bf16 whole
        rep = H // KV
        k_q, k_s = _quant(k_new)
        v_q, v_s = _quant(v_new)
        cache["k"][:, pos] = k_q[:, 0]
        cache["v"][:, pos] = v_q[:, 0]
        cache["k_scale"][:, pos] = k_s[:, 0]
        cache["v_scale"][:, pos] = v_s[:, 0]
        qg = q.reshape(B, 1, KV, rep, hd)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg,
                              cache["k"].to(torch.bfloat16)).float()
        # fold in the per-(token, head) scale: (B,S,KV,1)->(B,KV,1,1,S)
        ksT = cache["k_scale"].permute(0, 2, 3, 1)[:, :, :, None, :]
        logits = logits * ksT / math.sqrt(hd)
        kidx = torch.arange(cache["k"].shape[1], device=x.device)
        logits = logits.masked_fill(kidx > pos, NEG)
        w = torch.softmax(logits, dim=-1)
        vsT = cache["v_scale"].permute(0, 2, 3, 1)[:, :, :, None, :]
        o = torch.einsum("bgrqk,bkgd->bqgrd", (w * vsT).to(torch.bfloat16),
                         cache["v"].to(torch.bfloat16))
        o = o.reshape(B, 1, H, hd).to(x.dtype)
    else:
        cache["k"][:, pos] = k_new[:, 0]
        cache["v"][:, pos] = v_new[:, 0]
        o = _sdpa(q, cache["k"], cache["v"], causal=True, q_offset=pos)
    o = o.reshape(B, 1, H * hd)
    return _mm(o, compute_dtype(p["wo"])), cache


# ----------------------------------------------------------------- mlp
def init_mlp(generator, cfg, device=None):
    d, f = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    return {
        "wi": _normal(generator, (d, f), device) * s,
        "wg": _normal(generator, (d, f), device) * s,
        "wo": _normal(generator, (f, d), device) / math.sqrt(f),
    }


def mlp(x, p):
    h = _silu(_mm(x, compute_dtype(p["wg"]))) * _mm(x, compute_dtype(p["wi"]))
    return _mm(h, compute_dtype(p["wo"]))


# ----------------------------------------------------------------- MoE
def init_moe(generator, cfg, device=None):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = 1.0 / math.sqrt(d)
    return {
        "router": _normal(generator, (d, e), device) * s,
        "wi": _normal(generator, (e, d, f), device) * s,
        "wg": _normal(generator, (e, d, f), device) * s,
        "wo": _normal(generator, (e, f, d), device) / math.sqrt(f),
    }


MOE_SEQ_CHUNK = 4096


def moe(x, p, cfg, capacity_factor: float = 1.25):
    """Sequence-chunked wrapper over ``_moe_chunk``: long sequences are
    dispatched in <= MOE_SEQ_CHUNK slices, one after the other, so the
    (B, E*cap, D) dispatch buffer stays bounded.  Capacity is per chunk;
    the aux loss is the chunks' mean.  -> (y, aux)."""
    B, S, D = x.shape
    C = MOE_SEQ_CHUNK
    if S <= C:
        return _moe_chunk(x, p, cfg, capacity_factor)
    if S % C:
        raise ValueError(f"S={S} is not a multiple of MOE_SEQ_CHUNK={C}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(S // C):
        y, a = _moe_chunk(x[:, i * C : (i + 1) * C], p, cfg, capacity_factor)
        aux = aux + a
        ys.append(y)
    return torch.cat(ys, dim=1), aux / (S // C)


def _route(logits, n_experts: int, top_k: int, cap: int):
    """Token-choice top-k routing of f32 router ``logits`` (B, S, E) with
    ``cap`` slots per expert and batch row.  -> (probs, top_p, top_e,
    rank, keep).

    ``top_e`` orders equal probabilities lower expert first, as
    ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk``
    promises no order among ties).  A (token, k) pair's rank within its
    expert counts the pairs before it in (token, k) order: a stable sort
    of the flattened expert ids and, for each, the first position of its
    id (a leftmost ``searchsorted``).  Pairs ranked ``cap`` or later are
    dropped (``keep`` False) and pass through on the residual."""
    B, S, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :top_k], top_e[..., :top_k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    flat_e = top_e.reshape(B, S * top_k)
    sorted_e, order = torch.sort(flat_e, dim=1, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e)          # leftmost equal
    rank_sorted = torch.arange(S * top_k, device=logits.device) - first
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    rank = rank.reshape(B, S, top_k)
    return probs, top_p, top_e, rank, rank < cap


def _moe_chunk(x, p, cfg, capacity_factor: float = 1.25):
    """Token-choice top-k MoE with per-batch-row capacity.

    Each (token, k) pair that ``_route`` keeps is scattered to its slot
    ``expert * cap + rank`` of a (B, E*cap + 1, D) buffer; dropped pairs
    all go to the last row, which is cut off before the expert products
    (its duplicate writes land in any order, and nothing reads it).  The
    experts' SwiGLU runs as batched products over (E, cap), the outputs
    are gathered back (a dropped pair reads a zero row) and summed with
    the renormalised top-k weights.  -> (y, Switch-style aux loss)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    cap = max(int(capacity_factor * S * K / E), 1)
    logits = _mm(x, compute_dtype(p["router"])).float()
    probs, top_p, top_e, rank, keep = _route(logits, E, K, cap)
    slot = torch.where(keep, top_e * cap + rank, E * cap)     # (B, S, K)
    flat_slot = slot.reshape(B, S * K)

    rows = torch.arange(B, device=x.device)[:, None]
    buf = torch.zeros((B, E * cap + 1, D), dtype=x.dtype, device=x.device)
    buf[rows, flat_slot] = x.repeat_interleave(K, dim=1)
    # one (B * cap, D) block an expert: a batched product over E reads
    # each expert's weights once (broadcasting them over B would copy them)
    hidden = buf[:, :-1].reshape(B, E, cap, D).transpose(0, 1).reshape(
        E, B * cap, D)
    h = _silu(_mm(hidden, compute_dtype(p["wg"])))
    h = h * _mm(hidden, compute_dtype(p["wi"]))
    out = _mm(h, compute_dtype(p["wo"])).reshape(E, B, cap, D).transpose(0, 1)
    outflat = torch.cat([out.reshape(B, E * cap, D),
                         torch.zeros((B, 1, D), dtype=out.dtype,
                                     device=x.device)], dim=1)
    gathered = outflat[rows, flat_slot].reshape(B, S, K, D)
    combined = (gathered * top_p[..., None].to(out.dtype)).sum(2)
    # aux load-balancing loss (Switch-style), returned for the trainer
    me = probs.mean((0, 1))
    ce = torch.nn.functional.one_hot(top_e[..., 0], E).float().mean((0, 1))
    aux = E * (me * ce).sum()
    return combined, aux
