"""Weights from the reference's parameter pytree into the port."""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .transformer import TransformerLM


def _tensors(tree, dev):
    return {k: _tensors(v, dev) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)).to(dev)
            for k, v in tree.items()}


def params_from_jax(tree: dict, device=None) -> TransformerLM:
    """The reference's parameter tree (nested dicts whose leaves are numpy
    arrays, or anything ``np.array`` takes) as the port's parameters, name
    for name: the tree's paths are the module's parameter names.  ``device``
    None means the card."""
    return TransformerLM(_tensors(tree, resolve_device(device)))
