"""olmo-1b [dense]: non-parametric LayerNorm (no scale/bias).
[arXiv:2402.00838; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="olmo-1b", family="dense", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=8192, vocab_size=50304,
    norm="ln_nonparam")
