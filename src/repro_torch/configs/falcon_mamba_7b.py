"""falcon-mamba-7b [ssm]: attention-free Mamba-1, state 16.
[arXiv:2410.05355; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=65024,
    ssm_state=16, mamba_version=1, norm="rms", use_rope=False, head_dim=1)
