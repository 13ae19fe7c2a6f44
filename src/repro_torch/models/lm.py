"""Serving entry points: prefill and one-token decode factories, and greedy
generation (the reference's ``models/lm.py`` serving half).

Each entry point runs on the card unless it is given a device
(``core.device.resolve_device``): inputs are moved there, and the
parameters must already be there.  The loss, train and eval steps wait for
the training slice (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.device import resolve_device
from . import transformer


def _on(x, dev):
    return torch.as_tensor(x).to(dev)


def make_prefill_step(cfg, device=None):
    """Full-sequence forward (the prefill_* cells). Returns last logits."""
    dev = resolve_device(device)

    def prefill(params, batch):
        batch = {k: _on(v, dev) for k, v in batch.items()}
        logits, _ = transformer.forward(params, batch, cfg, last_only=True)
        return logits[:, -1]
    return prefill


def make_serve_step(cfg, seq_shard_axes: Sequence[str] = (), device=None):
    """One-token decode (the decode_* / long_* cells).  The cache is
    updated in place and returned."""
    dev = resolve_device(device)

    def serve_step(params, cache, token, pos):
        logits, cache = transformer.decode_step(
            params, cache, _on(token, dev), pos, cfg,
            seq_shard_axes=seq_shard_axes)
        return logits[:, -1], cache
    return serve_step


@torch.inference_mode()
def greedy_generate(params, cfg, prompt_tokens, n_new: int,
                    max_seq: int | None = None, kv_quant: bool = False,
                    device=None):
    """Small-scale generation helper (prefill by stepping, then decode).

    ``kv_quant`` (not in the reference's helper) decodes on an int8 cache.
    -> (B, S0 + n_new) tokens on the device."""
    dev = resolve_device(device)
    prompt_tokens = _on(prompt_tokens, dev)
    B, S0 = prompt_tokens.shape
    max_seq = max_seq or (S0 + n_new)
    cache = transformer.init_cache(cfg, B, max_seq, kv_quant=kv_quant,
                                   device=dev)
    serve = make_serve_step(cfg, device=dev)
    params = transformer.cast_params(params)    # once, not every step

    # prefill by stepping (simple + exact; fine for example scale)
    tok = prompt_tokens[:, :1]
    out = [prompt_tokens]
    for t in range(S0 + n_new - 1):
        logits, cache = serve(params, cache, tok, t)
        if t + 1 < S0:
            tok = prompt_tokens[:, t + 1 : t + 2]
        else:
            tok = torch.argmax(logits, dim=-1)[:, None].to(
                prompt_tokens.dtype)
            out.append(tok)
    return torch.cat(out, dim=1)
