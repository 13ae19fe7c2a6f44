"""Synthetic references and reads with ground truth (``genome``), and the
LM's deterministic token batches (``tokens``)."""
from . import genome, tokens  # noqa: F401
