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
  * **Retention**: the ``keep`` most recent checkpoints are retained.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..core.tree import leaves, unflatten


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
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
    arrays). extra: JSON-serializable.  -> the checkpoint's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:012d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {f"leaf_{i}": _host(leaf)
              for i, leaf in enumerate(leaves(state_tree))}
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


def restore(ckpt_dir: str, step: int, like_tree):
    """Restore into the structure of ``like_tree``: each leaf a tensor on
    the device of ``like_tree``'s leaf in its place.  Raises ValueError
    when the leaf count or a leaf's shape differs.  -> (tree, extra)."""
    path = os.path.join(ckpt_dir, f"step_{step:012d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    like = leaves(like_tree)
    if meta["n_leaves"] != len(like):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, "
                         f"expected {len(like)}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(like))]
    out = []
    for i, (old, new) in enumerate(zip(like, arrays)):
        if tuple(old.shape) != tuple(new.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {new.shape}, "
                             f"expected {tuple(old.shape)}")
        dev = old.device if isinstance(old, torch.Tensor) else "cpu"
        out.append(torch.from_numpy(new).to(dev))
    return unflatten(like_tree, out), meta["extra"]
