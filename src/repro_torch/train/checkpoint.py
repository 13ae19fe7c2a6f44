"""Checkpoints with atomic writes (the reference's ``train/checkpoint.py``).

  * **Atomic**: write to ``<dir>/tmp.<step>``, fsync, rename to
    ``<dir>/step_<step:012d>`` — a crash mid-write never corrupts the
    latest checkpoint; ``latest_step`` only sees fully renamed directories.
  * **Complete state**: the train state (params, optimizer state, step)
    plus ``extra`` (the data cursor ``next_step``).  With the batches
    deterministic by (seed, step) (``data.tokens``) a restart replays the
    same batches.
  * **The reference's files**: ``arrays.npz`` holds ``leaf_i`` in
    ``jax.tree``'s leaf order (``core.tree``) and ``meta.json`` the keys
    ``step``, ``n_leaves``, ``treedef`` and ``extra``, so a checkpoint
    written by either package restores in the other.  Neither package's
    ``restore`` reads ``treedef`` (both check the leaf count and shapes):
    the port writes a fixed note there.
  * **Elastic**: a sharded state (DTensor leaves, ``lm``'s sharded
    steps) is saved whole: ``save`` gathers each DTensor leaf
    (``full_tensor``, a collective every rank joins) and rank 0 alone
    writes.  ``restore(..., sharding_tree=)`` places each leaf as the
    tree says, so the restart mesh may differ from the save mesh.
  * **Retention**: the ``keep`` most recent checkpoints are retained.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..core.tree import leaves, unflatten


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _fsynced(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save(ckpt_dir: str, step: int, state_tree, extra: dict | None = None,
         keep: int = 3) -> str:
    """state_tree: nested dicts, tuples and lists of tensors (or numpy
    arrays). extra: JSON-serializable.  -> the checkpoint's directory.

    With DTensor leaves every rank of their mesh calls ``save``: each leaf
    is gathered whole, rank 0 writes, and all wait for it."""
    arrays = {f"leaf_{i}": _host(leaf)
              for i, leaf in enumerate(leaves(state_tree))}
    final = os.path.join(ckpt_dir, f"step_{step:012d}")
    if any(_is_dtensor(leaf) for leaf in leaves(state_tree)):
        import torch.distributed as dist
        if dist.get_rank() != 0:
            dist.barrier()
            return final
        try:
            _write(ckpt_dir, step, arrays, extra, keep)
        finally:
            dist.barrier()
        return final
    return _write(ckpt_dir, step, arrays, extra, keep)


def _write(ckpt_dir: str, step: int, arrays: dict, extra, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:012d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    _fsynced(os.path.join(tmp, "arrays.npz"),
             lambda f: np.savez(f, **arrays))
    meta = {"step": step, "n_leaves": len(arrays),
            "treedef": "leaves in jax.tree order", "extra": extra or {}}
    _fsynced(os.path.join(tmp, "meta.json"),
             lambda f: f.write(json.dumps(meta).encode()))
    if os.path.exists(final):
        shutil.rmtree(tmp)
    else:
        os.replace(tmp, final)
    # retention
    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:012d}"),
                      ignore_errors=True)
    return final


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
                  if name.startswith("step_"))


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like_tree, sharding_tree=None):
    """Restore into the structure of ``like_tree``: each leaf a tensor on
    the device of ``like_tree``'s leaf in its place or, with
    ``sharding_tree`` (a tree shaped as ``like_tree``), placed as its
    leaf there says: a ``models.layers.Sharding`` (``launch.mesh.named``)
    makes a DTensor on that mesh (elastic re-shard onto the active mesh),
    a device a plain tensor there.  Raises ValueError when the leaf count
    or a leaf's shape differs.  -> (tree, extra)."""
    path = os.path.join(ckpt_dir, f"step_{step:012d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    like = leaves(like_tree)
    if meta["n_leaves"] != len(like):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, "
                         f"expected {len(like)}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(like))]
    where = (leaves(sharding_tree) if sharding_tree is not None
             else [None] * len(like))
    if len(where) != len(like):
        raise ValueError(f"sharding_tree has {len(where)} leaves, expected "
                         f"{len(like)}")
    out = []
    for i, (old, new, w) in enumerate(zip(like, arrays, where)):
        if tuple(old.shape) != tuple(new.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {new.shape}, "
                             f"expected {tuple(old.shape)}")
        t = torch.from_numpy(new)
        if hasattr(w, "place"):
            out.append(w.place(t.to(w.mesh.device_type)))
            continue
        if w is None:
            w = old.device if isinstance(old, torch.Tensor) else "cpu"
        out.append(t.to(w))
    return unflatten(like_tree, out), meta["extra"]
