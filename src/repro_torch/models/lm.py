"""The LM's entry points (the reference's ``models/lm.py``): the loss, the
train and eval steps, the prefill and one-token decode factories, and
greedy generation.

Each entry point runs on the card unless it is given a device
(``core.device.resolve_device``): inputs are moved there, and the
parameters must already be there.  The serving entry points run under
``torch.inference_mode``; the train step takes gradients.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.device import resolve_device
from ..core.tree import leaves, tree_map, unflatten
from . import transformer

MOE_AUX_WEIGHT = 0.01


def _on(x, dev):
    return torch.as_tensor(x).to(dev)


def cross_entropy(logits, labels):
    """logits (B,S,V) any float dtype; labels (B,S) int -> scalar f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.take_along_dim(lf, labels[..., None].long(), dim=-1)[..., 0]
    return (lse - gold).mean()


def make_loss_fn(cfg):
    """(params, batch) -> (loss, {"ce", "moe_aux"}): the next-token cross
    entropy plus the MoE layers' load-balancing loss, weighted
    ``MOE_AUX_WEIGHT`` and averaged over layers."""
    def loss_fn(params, batch):
        logits, aux = transformer.forward(params, batch, cfg)
        ce = cross_entropy(logits, batch["labels"])
        loss = ce + MOE_AUX_WEIGHT * aux / max(cfg.n_layers, 1)
        return loss, {"ce": ce, "moe_aux": aux}
    return loss_fn


def make_grads_fn(cfg):
    """-> ``grads_of(params, batch) -> (loss, {"ce", "moe_aux"}, grads)``:
    the loss and its gradient against the bf16-cast tree, as the
    reference's ``make_train_step`` takes it (``grads_of``): the leaves of
    ``transformer.cast_params(params)`` (the float32 ones as they are) are
    made graph leaves, and the gradients, bf16 where the leaf is, are
    widened to float32.  The parameters themselves never require grad."""
    loss_fn = make_loss_fn(cfg)

    def grads_of(params, batch):
        pc = tree_map(lambda p: p.detach().requires_grad_(),
                      transformer.cast_params(params))
        with torch.enable_grad():
            loss, metrics = loss_fn(pc, batch)
            gb = torch.autograd.grad(loss, leaves(pc))
        grads = unflatten(pc, [g.float() for g in gb])
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads
    return grads_of


def microbatch(batch: dict, m: int, M: int) -> dict:
    """Microbatch ``m`` of ``M``: rows m, m + M, m + 2M, ... (stride M, as
    the reference's ``make_train_step`` interleaves them, so that every
    data shard contributes rows to every microbatch)."""
    return {k: v[m::M] for k, v in batch.items()}


def make_train_step(cfg, optimizer, num_microbatches: int = 1,
                    acc_dtype=torch.float32, device=None):
    """``optimizer``: a ``repro_torch.train.optimizer.Optimizer``.

    -> ``train_step(state, batch) -> (new_state, metrics)`` with ``state``
    = (params, opt_state, step): nested dicts of float32 tensors and a 0-d
    int32 step.  The step builds new tensors and writes none of its
    inputs, so it can be replayed on the same state.  ``metrics`` holds
    ``loss``, ``grad_norm``, ``ce`` and ``moe_aux`` as 0-d tensors.

    The gradient is ``make_grads_fn``'s.  ``num_microbatches`` M > 1
    accumulates the gradients of M microbatches (``microbatch``: rows at
    stride M) in ``acc_dtype``, so live activation memory scales 1/M
    while the math is the mean of the microbatches' gradients."""
    grads_of = make_grads_fn(cfg)
    dev = resolve_device(device)
    M = num_microbatches

    def train_step(state, batch):
        params, opt_state, step = state
        params = transformer.as_tree(params)
        batch = {k: _on(v, dev) for k, v in batch.items()}
        if M == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % M:
                raise ValueError(f"batch of {B} rows is not a multiple of "
                                 f"num_microbatches={M}")
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                                  device=p.device), params)
            ce_sum = torch.zeros((), dtype=torch.float32, device=dev)
            aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for m in range(M):
                _, mm, g = grads_of(params, microbatch(batch, m, M))
                gsum = tree_map(lambda a, b: (a + b.to(acc_dtype)).to(
                    acc_dtype), gsum, g)
                ce_sum = ce_sum + mm["ce"]
                aux_sum = aux_sum + mm["moe_aux"]
            grads = tree_map(lambda g: g.float() / M, gsum)
            loss = ce_sum / M + MOE_AUX_WEIGHT * (aux_sum / M) / max(
                cfg.n_layers, 1)
            metrics = {"ce": ce_sum / M, "moe_aux": aux_sum / M}
        updates, new_opt = optimizer.update(grads, opt_state, params, step)
        new_params = tree_map(lambda p, u: p + u, params, updates)
        gnorm = optimizer.global_norm(grads)
        return (new_params, new_opt, step + 1), {
            "loss": loss, "grad_norm": gnorm, **metrics}

    return train_step


def make_eval_step(cfg, device=None):
    """-> ``eval_step(params, batch) -> {"loss", "ce", "moe_aux"}``, the
    loss without gradients (past ``layers.ATTN_CHUNK_THRESHOLD`` the
    flash-attention kernel runs on the card)."""
    loss_fn = make_loss_fn(cfg)
    dev = resolve_device(device)

    @torch.inference_mode()
    def eval_step(params, batch):
        batch = {k: _on(v, dev) for k, v in batch.items()}
        loss, metrics = loss_fn(params, batch)
        return {"loss": loss, **metrics}

    return eval_step


def make_prefill_step(cfg, device=None):
    """Full-sequence forward (the prefill_* cells). Returns last logits."""
    dev = resolve_device(device)

    @torch.inference_mode()
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
