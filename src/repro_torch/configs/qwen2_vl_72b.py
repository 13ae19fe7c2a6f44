"""qwen2-vl-72b [vlm]: text backbone exact; vision frontend is a STUB —
input_specs feeds precomputed patch embeddings (B, S, d_model).  M-RoPE
reduces to 1-D RoPE for the text-only dry-run cells (see DESIGN.md).
[arXiv:2409.12191; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2-vl-72b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=29568, vocab_size=152064,
    input_kind="embeds", norm="rms", rope_theta=1e6)
