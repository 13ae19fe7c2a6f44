"""hubert-xlarge [audio]: encoder-only (bidirectional), frame-embedding
frontend is a STUB; classifier over 504 cluster units.  No decode step
(encoder) — decode cells are SKIP by design. [arXiv:2106.07447; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="hubert-xlarge", family="encoder", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab_size=504,
    causal=False, input_kind="embeds", norm="ln", use_rope=False)
