"""The LM scaffolding on torch tensors: the dense and encoder families'
serving path (prefill with the flash-attention kernel, KV-cache decode)."""
from . import convert, layers, lm, transformer  # noqa: F401
