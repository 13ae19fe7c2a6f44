"""qwen3-0.6b [dense]: qk-norm, GQA, head_dim=128. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen3-0.6b", family="dense", n_layers=28, d_model=1024,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=3072, vocab_size=151936,
    qk_norm=True, norm="rms", rope_theta=1e6)
