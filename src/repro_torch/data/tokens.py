"""Deterministic, shardable synthetic LM token pipeline (numpy).

A copy of the reference's ``data/tokens.py``, bit for bit:
  * **Deterministic by (seed, step, shard)** — any host can regenerate any
    batch shard independently; a restarted node needs only the step
    counter from the checkpoint, which is what makes restart exact.
  * **Static shapes** — batches are never ragged, so steps are replayable.
"""
from __future__ import annotations

import numpy as np


def batch_for_step(step: int, *, global_batch: int, seq_len: int,
                   vocab_size: int, seed: int = 0,
                   shard_index: int = 0, num_shards: int = 1):
    """Return (tokens, labels) for this host's shard of global batch ``step``.

    tokens/labels are int32 (global_batch // num_shards, seq_len).  Labels
    are next-token shifted with a structured pattern (token ~ mix of zipf-ish
    ids) so loss curves are non-degenerate in the examples.
    """
    if global_batch % num_shards:
        raise ValueError(f"global_batch={global_batch} is not a multiple "
                         f"of num_shards={num_shards}")
    local = global_batch // num_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard_index]))
    # zipf-ish marginal over vocab, cheap to sample: square a uniform
    u = rng.random((local, seq_len + 1))
    toks = (u * u * (vocab_size - 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]
