"""Roofline terms per (arch x shape x mesh) cell, for the NVIDIA H100.

Hardware model (H100 SXM5, per device; NVIDIA H100 Tensor Core GPU
datasheet, SXM column):
  peak bf16 (dense)  989 TFLOP/s   (1,979 with 2:4 sparsity, not used)
  HBM3 bandwidth     3.35 TB/s
  NVLink 4           900 GB/s total, 450 GB/s per direction

Methodology, as the reference's (``repro/launch/roofline.py``): an exact
analytic matmul/op count derived from the model definitions (the port's
layers compute the reference's einsums, and the count is checked against
``torch.utils.flop_counter.FlopCounterMode`` on an unrolled forward,
``tests/test_torch_roofline.py``), analytic per-device HBM bytes, and
ring-model collective bytes over the links.  The terms are the
reference's, name for name; only the hardware constants differ.
"""
from __future__ import annotations

import dataclasses
import math

PEAK_FLOPS = 989e12   # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12      # HBM3 bytes/s
LINK_BW = 450e9       # NVLink 4 bytes/s per direction

BYTES_BF16 = 2
BYTES_F32 = 4


# --------------------------------------------------------------- FLOPs model
def _attn_proj_flops(cfg):
    """Per token: q/k/v/o projections (2*m*n*k per matmul)."""
    d, hd = cfg.d_model, cfg.head_dim
    return 2 * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)


def _attn_score_flops(cfg, s_ctx):
    """Per token, attending over s_ctx keys: QK^T + PV."""
    return 2 * 2 * cfg.n_heads * cfg.head_dim * s_ctx


def _mlp_flops(cfg):
    return 2 * 3 * cfg.d_model * cfg.d_ff


def _moe_flops(cfg, capacity_factor=1.25):
    """Per token: router + top_k experts (x capacity padding)."""
    router = 2 * cfg.d_model * cfg.n_experts
    experts = 2 * 3 * cfg.d_model * cfg.d_ff * cfg.top_k * capacity_factor
    return router + experts


def _mamba1_flops(cfg):
    d, di, N = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    proj = 2 * d * 2 * di + 2 * di * (cfg.ssm_dt_rank + 2 * N) \
        + 2 * cfg.ssm_dt_rank * di + 2 * di * d
    conv = 2 * cfg.ssm_conv * di
    # associative scan: log2(C) combine steps, 3 mul/add per (di, N) element
    scan = 3 * di * N * (math.ceil(math.log2(max(cfg.ssm_chunk, 2))) + 2)
    y = 2 * di * N
    return proj + conv + scan + y


def _mamba2_flops(cfg):
    d, di, N = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    H, Pd = cfg.ssm_heads, cfg.ssm_d_inner // cfg.ssm_heads
    C = cfg.ssm_chunk
    proj = 2 * d * (2 * di + 2 * N + H) + 2 * di * d
    conv = 2 * cfg.ssm_conv * (di + 2 * N)
    # SSD per token: CB^T (C*N) + att@x (C*H*P) + state update (N*H*P) etc.
    ssd = 2 * C * N + 2 * C * H * Pd + 4 * N * H * Pd
    return proj + conv + ssd


def _layer_flops(cfg, s_ctx, decode=False):
    """Per token forward flops for one layer (s_ctx = attention context)."""
    if cfg.family in ("dense", "encoder"):
        return _attn_proj_flops(cfg) + _attn_score_flops(cfg, s_ctx) \
            + _mlp_flops(cfg)
    if cfg.family == "moe":
        cf = cfg.n_experts / cfg.top_k if decode else 1.25
        return _attn_proj_flops(cfg) + _attn_score_flops(cfg, s_ctx) \
            + _moe_flops(cfg, cf)
    if cfg.family == "ssm":
        return _mamba1_flops(cfg)
    if cfg.family == "hybrid":
        f = _mamba2_flops(cfg)
        if cfg.attn_every:
            shared = (_attn_proj_flops(cfg)
                      + _attn_score_flops(cfg, s_ctx)) / cfg.attn_every
            f += shared
        return f
    raise ValueError(cfg.family)


def forward_flops(cfg, n_tokens, s_ctx, decode=False, with_unembed=True,
                  unembed_tokens=None):
    """Global forward FLOPs for n_tokens (each attending s_ctx)."""
    per_tok = _layer_flops(cfg, s_ctx, decode) * cfg.n_layers
    un = 2 * cfg.d_model * cfg.vocab_size * (
        unembed_tokens if unembed_tokens is not None else n_tokens)
    return per_tok * n_tokens + (un if with_unembed else 0)


def cell_flops(cfg, shape) -> dict:
    """Global FLOPs per step + the 'useful' 6*N*D (2*N*D serve) number."""
    B, S = shape.global_batch, shape.seq_len
    n_tok = B * S
    if shape.kind == "train":
        # bwd = 2x fwd; full remat recomputes fwd once more
        fwd = forward_flops(cfg, n_tok, s_ctx=S / 2)  # causal avg context
        # chunked attention computes the full rectangle (masked): the causal
        # waste is part of HLO flops, so count s_ctx=S for hlo-comparable.
        fwd_hlo = forward_flops(cfg, n_tok, s_ctx=S)
        total = 4 * fwd_hlo
        useful = 6 * cfg.active_params() * n_tok
    elif shape.kind == "prefill":
        fwd_hlo = forward_flops(cfg, n_tok, s_ctx=S, with_unembed=True,
                                unembed_tokens=B)
        total = fwd_hlo
        useful = 2 * cfg.active_params() * n_tok
    else:  # decode: B new tokens, context S
        total = forward_flops(cfg, B, s_ctx=S, decode=True)
        useful = 2 * cfg.active_params() * B
    return {"hlo_like_total": total, "useful": useful}


# --------------------------------------------------------------- bytes model
def param_bytes(cfg) -> int:
    return cfg.n_params() * BYTES_F32


def cell_hbm_bytes(cfg, shape, n_dev, n_micro=1) -> float:
    """Per-device HBM traffic per step (analytic, documented assumptions).

    train: each microbatch reads all (gathered) weights fwd + bwd + recompute
           (3 passes, bf16 compute reads) + optimizer read/write f32 x3;
    prefill/decode: one weight pass; decode additionally reads the KV cache
    (or SSM state) once per token.
    """
    pb = param_bytes(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        w = 3 * n_micro * pb / 2 * BYTES_BF16 / BYTES_F32  # bf16 reads
        opt = 3 * pb  # adam m,v read+write + param update
        act = B * S * cfg.d_model * BYTES_BF16 * cfg.n_layers * 4 / n_dev
        return (w + opt) / n_dev + act
    if shape.kind == "prefill":
        w = pb / 2
        act = B * S * cfg.d_model * BYTES_BF16 * cfg.n_layers * 2 / n_dev
        return w / n_dev + act
    # decode
    w = pb / 2
    kv = 0.0
    if cfg.family in ("dense", "moe", "encoder"):
        kv = (cfg.n_layers * B * S * cfg.n_kv_heads * cfg.head_dim
              * 2 * BYTES_BF16)
    elif cfg.family == "hybrid" and cfg.attn_every:
        sites = cfg.n_layers // cfg.attn_every
        kv = sites * B * S * cfg.n_kv_heads * cfg.head_dim * 2 * BYTES_BF16
        kv += (cfg.n_layers * B * cfg.ssm_d_inner * cfg.ssm_state
               * BYTES_F32)
    elif cfg.family == "ssm":
        kv = cfg.n_layers * B * cfg.ssm_d_inner * cfg.ssm_state * BYTES_F32
    return (w + kv) / n_dev


def _tp_allreduces_per_layer(cfg) -> float:
    """TP activation all-reduces per layer (Megatron accounting).

    dense/encoder: attn-out + mlp-out = 2.  moe: attn-out + expert combine
    = 2 (dispatch from batch-replicated activations is a local slice —
    GSPMD moves no bytes; only the combine reduces over the expert/model
    axis).  ssm: out_proj only = 1.  hybrid: mamba out_proj + shared attn
    amortized = 1 + 1/attn_every.
    """
    if cfg.family in ("dense", "encoder", "moe"):
        return 2.0
    if cfg.family == "ssm":
        return 1.0
    if cfg.family == "hybrid":
        return 1.0 + (1.0 / cfg.attn_every if cfg.attn_every else 0.0)
    raise ValueError(cfg.family)


def cell_collective_bytes(cfg, shape, mesh_shape: dict, n_micro=1) -> float:
    """Per-device link bytes per step (ring formulas, analytic).

    Counted: FSDP weight all-gather (per microbatch) + gradient
    reduce-scatter/all-gather over data(+pod) + TP activation all-reduces
    (expert combine included, see _tp_allreduces_per_layer).
    """
    d_ax = mesh_shape.get("data", 1)
    p_ax = mesh_shape.get("pod", 1)
    m_ax = mesh_shape.get("model", 1)
    pb_bf16 = cfg.n_params() * BYTES_BF16
    B, S = shape.global_batch, shape.seq_len
    tok_dev = B * S / max(d_ax * p_ax, 1)
    n_ar = _tp_allreduces_per_layer(cfg)

    total = 0.0
    if shape.kind == "train":
        # FSDP gather: each device receives its missing (d-1)/d of the
        # model-shard slice, fwd + bwd + remat recompute, per microbatch
        total += 3 * n_micro * (pb_bf16 / m_ax) * (d_ax - 1) / d_ax
        # grad reduce over data x pod (two-level ring all-reduce, f32)
        gb = cfg.n_params() * BYTES_F32 / m_ax
        total += 2 * gb * (d_ax - 1) / d_ax
        total += 2 * (gb / d_ax) * (p_ax - 1) / max(p_ax, 1)
        # TP all-reduce of layer outputs, fwd + bwd + recompute
        act = tok_dev * cfg.d_model * BYTES_BF16
        total += 3 * n_ar * cfg.n_layers * 2 * act * (m_ax - 1) / m_ax
    elif shape.kind == "prefill":
        total += (pb_bf16 / m_ax) * (d_ax - 1) / d_ax
        act = tok_dev * cfg.d_model * BYTES_BF16
        total += n_ar * cfg.n_layers * 2 * act * (m_ax - 1) / m_ax
    else:  # decode: bf16 weights resident (no per-token FSDP gather);
        # MoE keeps the fsdp axis for its expert tables
        if cfg.family == "moe" or cfg.n_params() >= 32e9:
            total += (pb_bf16 / m_ax) * (d_ax - 1) / d_ax
        act = (B / max(d_ax * p_ax, 1)) * cfg.d_model * BYTES_BF16
        total += n_ar * cfg.n_layers * 2 * act * (m_ax - 1) / m_ax
    return total


@dataclasses.dataclass(frozen=True)
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_dev: float
    hbm_bytes_per_dev: float
    link_bytes_per_dev: float
    useful_flops: float
    useful_ratio: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / achievable step time (the score)."""
        useful_s = self.useful_flops / PEAK_FLOPS
        return useful_s / max(self.bound_s, 1e-30)


def cell_roofline(cfg, shape, mesh_shape: dict, n_micro: int = 1) -> Roofline:
    n_dev = 1
    for v in mesh_shape.values():
        n_dev *= v
    fl = cell_flops(cfg, shape)
    flops_dev = fl["hlo_like_total"] / n_dev
    hbm = cell_hbm_bytes(cfg, shape, n_dev, n_micro)
    link = cell_collective_bytes(cfg, shape, mesh_shape, n_micro)
    useful_dev = fl["useful"] / n_dev
    return Roofline(
        compute_s=flops_dev / PEAK_FLOPS,
        memory_s=hbm / HBM_BW,
        collective_s=link / LINK_BW,
        flops_per_dev=flops_dev,
        hbm_bytes_per_dev=hbm,
        link_bytes_per_dev=link,
        useful_flops=useful_dev,
        useful_ratio=fl["useful"] / max(fl["hlo_like_total"], 1e-30),
    )
