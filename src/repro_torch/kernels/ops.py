"""Wrappers of the Hopper kernels, with their launch counters.

Each wrapper takes the natural row layout — reads ``s1`` (R, n) and
windows ``s2_window`` (R, n + 2*eth), both uint8 and contiguous — checks
it, and then:

  * on CUDA tensors launches its kernel on the tensor's device and that
    device's current stream (building the library at first use), and
    adds one to its entry of ``LAUNCHES``; a refused launch raises;
  * on CPU tensors runs the kernel's plain torch version from
    ``repro_torch.core`` — the only case where the plain version stands
    in, and it does so because of where the tensor lies.

The counters count launches and nothing else, so a run can show that
its main path went through the kernels.
"""
from __future__ import annotations

import torch

from ..core.affine_wf import banded_affine, banded_affine_dist, traceback
from ..core.linear_wf import banded_wf
from . import build

LAUNCHES = {"linear_wf": 0, "affine_wf_dist": 0, "affine_traceback": 0}
SUPPORTED_ETH = (4, 6, 8)   # template instances compiled into csrc/
MAX_SAT = 85                # above it the reference's int8 values wrap
SMEM_LIMIT = 232_448        # dynamic shared memory a Hopper block may use
THREADS = 128               # linear / affine-distance block size


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(s1: torch.Tensor, s2_window: torch.Tensor, eth: int) -> None:
    for name, t in (("s1", s1), ("s2_window", s2_window)):
        if t.dtype != torch.uint8:
            raise TypeError(f"{name} must be uint8, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor, got "
                             f"shape {tuple(t.shape)}")
    R, n = s1.shape
    if tuple(s2_window.shape) != (R, n + 2 * eth):
        raise ValueError(f"s2_window shape {tuple(s2_window.shape)} does "
                         f"not match s1 {(R, n)} with eth={eth}")
    if s1.device != s2_window.device:
        raise ValueError(f"s1 on {s1.device}, s2_window on "
                         f"{s2_window.device}")


def _on_card(s1: torch.Tensor, eth: int, sat: int | None = None) -> bool:
    """False for CPU tensors (plain version); True for CUDA tensors the
    kernels take; raises for anything else."""
    if s1.device.type == "cpu":
        return False
    if s1.device.type != "cuda":
        raise ValueError(f"no kernel for device {s1.device}")
    if eth not in SUPPORTED_ETH:
        raise ValueError(f"eth={eth} has no compiled kernel instance; "
                         f"supported: {SUPPORTED_ETH}")
    if sat is not None and not 0 <= sat <= MAX_SAT:
        raise ValueError(f"sat={sat} outside [0, {MAX_SAT}]: the "
                         f"reference's int8 band values would wrap")
    return True


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def linear_wf(s1: torch.Tensor, s2_window: torch.Tensor, *, eth: int = 6):
    """Banded linear WF.  -> (dist_end (R,), dist_min (R,)) int32."""
    _check(s1, s2_window, eth)
    if not _on_card(s1, eth):
        return banded_wf(s1, s2_window, eth=eth)
    R, n = s1.shape
    out = torch.empty((2, R), dtype=torch.int32, device=s1.device)
    if R:
        smem = THREADS * (2 * n + 2 * eth)
        with torch.cuda.device(s1.device):
            rc = build.entry("linear_wf_launch")(
                s1.data_ptr(), s2_window.data_ptr(), out.data_ptr(), R, n,
                eth, THREADS, smem, _stream(s1))
        _raise_on(rc, "linear_wf")
        LAUNCHES["linear_wf"] += 1
    return out[0], out[1]


def affine_wf_dist(s1: torch.Tensor, s2_window: torch.Tensor, *,
                   eth: int = 6, sat: int = 32):
    """Distance-only banded affine WF.  -> (dist_end, dist_min) int32."""
    _check(s1, s2_window, eth)
    if not _on_card(s1, eth, sat):
        return banded_affine_dist(s1, s2_window, eth=eth, sat=sat)
    R, n = s1.shape
    out = torch.empty((2, R), dtype=torch.int32, device=s1.device)
    if R:
        smem = THREADS * (2 * n + 2 * eth)
        with torch.cuda.device(s1.device):
            rc = build.entry("affine_wf_dist_launch")(
                s1.data_ptr(), s2_window.data_ptr(), out.data_ptr(), R, n,
                eth, sat, THREADS, smem, _stream(s1))
        _raise_on(rc, "affine_wf_dist")
        LAUNCHES["affine_wf_dist"] += 1
    return out[0], out[1]


def traceback_threads(n: int, eth: int) -> int:
    """Threads per block of the fused traceback kernel: the most of 64
    and 32 whose direction bytes (n * band per thread) fit in shared
    memory."""
    per_thread = n * (2 * eth + 1)
    for threads in (64, 32):
        if threads * per_thread <= SMEM_LIMIT:
            return threads
    raise ValueError(f"n={n}, eth={eth}: {per_thread} direction bytes per "
                     f"instance do not fit 32 instances in "
                     f"{SMEM_LIMIT} B of shared memory")


def affine_traceback(s1: torch.Tensor, s2_window: torch.Tensor, *,
                     eth: int = 6, sat: int = 32, max_ops: int):
    """Fused banded affine WF + traceback.  -> (dist_end (R,), dist_min
    (R,), ops (R, max_ops) int32 END-aligned, op_count (R,) int32)."""
    _check(s1, s2_window, eth)
    if max_ops < 1:
        raise ValueError(f"max_ops={max_ops} must be >= 1")
    if not _on_card(s1, eth, sat):
        de, dm, dirs = banded_affine(s1, s2_window, eth=eth, sat=sat)
        ops_, cnt = traceback(dirs, eth, max_ops)
        return de, dm, ops_, cnt
    R, n = s1.shape
    threads = traceback_threads(n, eth)
    dev = s1.device
    dists = torch.empty((2, R), dtype=torch.int32, device=dev)
    ops_ = torch.empty((R, max_ops), dtype=torch.int32, device=dev)
    cnt = torch.empty((R,), dtype=torch.int32, device=dev)
    if R:
        smem = threads * n * (2 * eth + 1)
        with torch.cuda.device(dev):
            rc = build.entry("affine_traceback_launch")(
                s1.data_ptr(), s2_window.data_ptr(), dists.data_ptr(),
                ops_.data_ptr(), cnt.data_ptr(), R, n, eth, sat, max_ops,
                threads, smem, _stream(s1))
        _raise_on(rc, "affine_traceback")
        LAUNCHES["affine_traceback"] += 1
    return dists[0], dists[1], ops_, cnt
