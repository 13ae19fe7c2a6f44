"""Candidate compaction: static-capacity valid-only buckets — torch twin
of ``repro.core.compaction``.

  * ``bucket_capacity``  — host-side power-of-two, ``align``-multiple
    capacity for a measured count; the kernels' instance counts (and so
    ``MapperStats``) follow the reference's buckets;
  * ``compact_indices``  — order-preserving compaction of a boolean mask
    into a ``(cap,)`` slot table by rank-scatter (no sort, no host sync);
  * ``scatter_to``       — inverse scatter of per-slot results, invalid
    slots written to a shadow row that is sliced off.
"""
from __future__ import annotations

import torch


def bucket_capacity(count: int, *, align: int, cap_max: int) -> int:
    """Smallest power-of-two >= count, >= align, <= next_pow2(cap_max)."""
    if not (align >= 1 and (align & (align - 1)) == 0):
        raise ValueError(f"align={align!r} must be a power of two")
    cap = max(int(count), 1)
    cap = 1 << (cap - 1).bit_length()          # next power of two
    cap = max(cap, align)
    ceil_ = max(cap_max, 1)
    ceil_ = 1 << (ceil_ - 1).bit_length()
    return min(cap, max(ceil_, align))


def compact_indices(valid: torch.Tensor, cap: int):
    """valid: (N,) bool -> (slots (cap,) int64, slot_valid (cap,) bool):
    ``slots[s]`` is the flat index of the s-th valid entry, original order
    kept; entries past ``cap`` valids are dropped."""
    N = valid.shape[0]
    dev = valid.device
    rank = torch.cumsum(valid.to(torch.int64), dim=0) - 1
    slot = torch.where(valid & (rank < cap), rank, cap)   # overflow -> cap
    slots = torch.zeros(cap + 1, dtype=torch.int64, device=dev).scatter_(
        0, slot, torch.arange(N, device=dev))[:cap]
    slot_valid = torch.zeros(cap + 1, dtype=torch.bool, device=dev).scatter_(
        0, slot, torch.ones(N, dtype=torch.bool, device=dev))[:cap]
    return slots, slot_valid


def scatter_to(n_flat: int, slots: torch.Tensor, slot_valid: torch.Tensor,
               values: torch.Tensor, fill) -> torch.Tensor:
    """Scatter per-slot ``values`` back to a (n_flat, ...) tensor, ``fill``
    elsewhere.  Invalid slots write to a shadow row that is sliced off, so
    their duplicate slot-0 entries never clobber candidate 0."""
    dst = torch.where(slot_valid, slots, n_flat)
    out = torch.full((n_flat + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out[dst] = values
    return out[:n_flat]
