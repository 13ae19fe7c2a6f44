"""The LM scaffolding on torch tensors: the serving path of every family
(dense, encoder, moe, ssm, hybrid): prefill with the flash-attention
kernel, KV-cache and SSM-state decode."""
from . import convert, layers, lm, ssm, transformer  # noqa: F401
