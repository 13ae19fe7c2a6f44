"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 experts top-6.
(Shared-expert path of Moonlight is omitted — noted in DESIGN.md.)
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=163840,
    n_experts=64, top_k=6, norm="rms")
