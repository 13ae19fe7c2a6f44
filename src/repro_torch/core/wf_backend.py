"""WF backend dispatch: ``"cuda"`` kernels | ``"torch"`` plain versions —
the twin of ``repro.core.wf_backend``'s ``"pallas"`` | ``"jnp"``, and the
same choice for the minimizer scan of seeding and the index build.

  * ``"cuda"``  — the hand-written Hopper kernels of
    ``repro_torch.kernels``: launched for CUDA tensors; CPU tensors get
    the kernels' plain versions (that is how the CPU tests run);
  * ``"torch"`` — the plain torch versions of ``repro_torch.core`` on any
    device.

All entry points accept arbitrary leading batch dims.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .affine_wf import banded_affine, banded_affine_dist, traceback
from .linear_wf import banded_wf
from .minimizers import minimizers as plain_minimizers

BACKENDS = ("cuda", "torch")


def _check(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"wf_backend must be one of {BACKENDS}, "
                         f"got {backend!r}")


def _rows(s1: torch.Tensor, s2_window: torch.Tensor):
    return (s1.reshape(-1, s1.shape[-1]).contiguous(),
            s2_window.reshape(-1, s2_window.shape[-1]).contiguous())


def linear_wf_dist(s1: torch.Tensor, s2_window: torch.Tensor, *, eth: int,
                   backend: str = "cuda"):
    """Banded linear WF distances.  s1 (..., n), s2_window (..., n+2*eth)
    -> (dist_end, dist_min) int32 of shape (...)."""
    _check(backend)
    if backend == "torch":
        return banded_wf(s1, s2_window, eth=eth)
    lead = s1.shape[:-1]
    de, dm = ops.linear_wf(*_rows(s1, s2_window), eth=eth)
    return de.reshape(lead), dm.reshape(lead)


def affine_wf_dist(s1: torch.Tensor, s2_window: torch.Tensor, *, eth: int,
                   sat: int, backend: str = "cuda"):
    """Distance-only banded affine WF -> (dist_end, dist_min) int32."""
    _check(backend)
    if backend == "torch":
        return banded_affine_dist(s1, s2_window, eth=eth, sat=sat)
    lead = s1.shape[:-1]
    de, dm = ops.affine_wf_dist(*_rows(s1, s2_window), eth=eth, sat=sat)
    return de.reshape(lead), dm.reshape(lead)


def affine_wf_dirs(s1: torch.Tensor, s2_window: torch.Tensor, *, eth: int,
                   sat: int, backend: str = "cuda"):
    """Banded affine WF with packed direction planes (the padded engine's
    pass).  Returns (dist_end, dist_min, dirs (..., n, 2*eth+1) uint8)."""
    _check(backend)
    if backend == "torch":
        return banded_affine(s1, s2_window, eth=eth, sat=sat)
    lead = s1.shape[:-1]
    n = s1.shape[-1]
    de, dm, dirs = ops.affine_wf(*_rows(s1, s2_window), eth=eth, sat=sat)
    return (de.reshape(lead), dm.reshape(lead),
            dirs.reshape(lead + (n, 2 * eth + 1)))


def affine_traceback(s1: torch.Tensor, s2_window: torch.Tensor, *, eth: int,
                     sat: int, max_ops: int, backend: str = "cuda"):
    """Banded affine WF + traceback in one pass (the winners-only pass).

    On ``"cuda"`` the fused kernel keeps the direction bytes in shared
    memory; on ``"torch"`` ``banded_affine`` and the batched ``traceback``
    run back to back.  Returns (dist_end, dist_min, ops (..., max_ops)
    int32 END-aligned, op_count (...,) int32).
    """
    _check(backend)
    if backend == "torch":
        de, dm, dirs = banded_affine(s1, s2_window, eth=eth, sat=sat)
        ops_, cnt = traceback(dirs, eth, max_ops)
        return de, dm, ops_, cnt
    lead = s1.shape[:-1]
    de, dm, ops_, cnt = ops.affine_traceback(*_rows(s1, s2_window), eth=eth,
                                             sat=sat, max_ops=max_ops)
    return (de.reshape(lead), dm.reshape(lead),
            ops_.reshape(lead + (max_ops,)), cnt.reshape(lead))


def minimizers(seq: torch.Tensor, *, k: int, w: int, backend: str = "cuda"):
    """Window minimizers of ``seq`` (..., L) uint8 -> (k-mer codes,
    positions), each (..., L - (w + k - 1) + 1) int64: what seeding and
    the index build consume of ``core.minimizers.minimizers``.

    On ``"cuda"`` the minimizer kernel writes the codes itself
    (``ops.minimizer_scan(..., codes=True)``); on ``"torch"`` the plain
    ``core.minimizers.minimizers`` runs, which stays the kernel's
    yardstick and never dispatches.
    """
    _check(backend)
    if backend == "torch":
        return plain_minimizers(seq, k=k, w=w)[1:]
    lead = seq.shape[:-1]
    codes, pos = ops.minimizer_scan(seq.reshape(-1, seq.shape[-1])
                                    .contiguous(), k=k, w=w, codes=True)
    return codes.reshape(lead + (-1,)), pos.reshape(lead + (-1,))
