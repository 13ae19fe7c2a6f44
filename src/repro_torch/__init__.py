"""PyTorch/CUDA port of the DART-PIM read mapper (``repro``'s twin).

``repro_torch.core`` holds the mapping pipeline on torch tensors and
``repro_torch.kernels`` the hand-written Hopper kernels that carry its
banded Wagner-Fischer stages.  The package imports torch and numpy only:
no JAX, and nothing of ``repro``.
"""
