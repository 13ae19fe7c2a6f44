"""qwen3-moe-235b-a22b [moe]: 128 experts top-8, per-expert d_ff=1536,
GQA kv=4, qk-norm, head_dim=128. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, head_dim=128, d_ff=1536, vocab_size=151936,
    n_experts=128, top_k=8, qk_norm=True, norm="rms", rope_theta=1e6)
