"""Where the port's entry points run: on the card unless asked otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; any other value is taken as given.

    Raises when no device was named and no GPU is present, rather than
    dropping to the CPU unasked.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device=\"cpu\" "
                           "to run the port on the CPU")
    return torch.device("cuda")
