"""smollm-135m [dense]: llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="smollm-135m", family="dense", n_layers=30, d_model=576,
    n_heads=9, n_kv_heads=3, d_ff=1536, vocab_size=49152, norm="rms")
