"""Config registry: one module per assigned architecture (+ the paper's own).

``get_config(arch_id)`` resolves --arch flags; ``reduced(cfg)`` shrinks any
config to a CPU-smoke-test size preserving its family wiring.
"""
from __future__ import annotations

import dataclasses

from .base import ModelConfig, ShapeCell, SHAPES, cell_applicable

from . import (falcon_mamba_7b, hubert_xlarge, moonshot_16b, olmo_1b,
               qwen2_vl_72b, qwen3_0p6b, qwen3_moe_235b, smollm_135m,
               stablelm_3b, zamba2_2p7b)

ARCHS = {
    m.CONFIG.arch: m.CONFIG
    for m in (zamba2_2p7b, olmo_1b, stablelm_3b, qwen3_0p6b, smollm_135m,
              qwen2_vl_72b, hubert_xlarge, falcon_mamba_7b, qwen3_moe_235b,
              moonshot_16b)
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    return ARCHS[arch]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    changes = dict(
        n_layers=min(cfg.n_layers, 4) if cfg.family != "hybrid" else 4,
        d_model=128, d_ff=256 if cfg.d_ff else 0, vocab_size=512,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=32 if cfg.n_heads else 1,
        n_experts=8 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2),
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_chunk=16,
        attn_every=2 if cfg.attn_every else 0,
        remat=False,
    )
    return dataclasses.replace(cfg, **changes)


__all__ = ["ARCHS", "get_config", "reduced", "ModelConfig", "ShapeCell",
           "SHAPES", "cell_applicable"]
