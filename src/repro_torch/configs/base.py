"""Model/arch configuration schema + input shape cells.

Every assigned architecture is a ``ModelConfig``; the four assignment shapes
are ``ShapeCell``s.  Modality frontends ([audio]/[vlm]) are stubs:
``input_kind='embeds'`` feeds precomputed frame/patch embeddings straight to
the backbone.  ``input_specs`` (the dry-run's abstract inputs) is not here:
it waits for the dry-run.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                     # dense | moe | ssm | hybrid | encoder
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                       # per-expert width for MoE
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    norm: str = "rms"               # rms | ln | ln_nonparam
    qk_norm: bool = False
    use_rope: bool = True
    rope_theta: float = 10_000.0
    causal: bool = True
    input_kind: str = "tokens"      # tokens | embeds
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128
    mamba_version: int = 0
    # hybrid (zamba-style): one SHARED attention block applied every N layers
    attn_every: int = 0
    # training
    remat: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived SSM dims
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_dt_rank(self) -> int:
        return max(1, math.ceil(self.d_model / 16))

    @property
    def ssm_heads(self) -> int:
        return max(1, self.ssm_d_inner // 64)

    # ---- capabilities
    @property
    def supports_decode(self) -> bool:
        return self.family != "encoder"

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Approximate parameter count (embeddings included)."""
        d, L = self.d_model, self.n_layers
        hd = self.head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.family == "moe":
            ffn = 3 * d * self.d_ff * self.n_experts + d * self.n_experts
        elif self.family in ("ssm", "hybrid"):
            di, N = self.ssm_d_inner, self.ssm_state
            if self.mamba_version == 1:
                ffn = (d * 2 * di + di * (self.ssm_dt_rank + 2 * N)
                       + self.ssm_dt_rank * di + di * N + di * d)
            else:
                ffn = d * (2 * di + 2 * N + self.ssm_heads) + di * d
        else:
            ffn = 3 * d * self.d_ff
        per_layer = ffn if self.family == "ssm" else attn + ffn
        if self.family == "hybrid":
            per_layer = ffn  # mamba layers; one shared attn added below
        total = L * per_layer + 2 * self.vocab_size * d
        if self.family == "hybrid":
            total += attn
        if self.family == "ssm":
            total = L * ffn + 2 * self.vocab_size * d
        return total

    def active_params(self) -> int:
        """Active-per-token params (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.n_params()
        d, L = self.d_model, self.n_layers
        attn = d * self.head_dim * (self.n_heads * 2 + self.n_kv_heads * 2)
        ffn = 3 * d * self.d_ff * self.top_k
        return L * (attn + ffn) + 2 * self.vocab_size * d


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per DESIGN.md §Arch-applicability."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full attention is O(L^2); 500k context needs " \
                      "sub-quadratic (SSM/hybrid) sequence mixing"
    return True, ""
