"""zamba2-2.7b [hybrid]: Mamba2 backbone + ONE shared attention block applied
every 6 layers (zamba-style weight sharing). [arXiv:2411.15242; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=32000,
    ssm_state=64, mamba_version=2, attn_every=6, norm="rms")
