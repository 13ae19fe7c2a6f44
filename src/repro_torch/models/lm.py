"""The LM's entry points (the reference's ``models/lm.py``): the loss, the
train and eval steps, the prefill and one-token decode factories, and
greedy generation.

Each entry point runs on the card unless it is given a device
(``core.device.resolve_device``): inputs are moved there, and the
parameters must already be there.  The serving entry points run under
``torch.inference_mode`` (``torch.no_grad`` on DTensors); the train step
takes gradients.

Sharded steps (keyword ``sh``, a ``layers.Shardings``): the parameters,
optimizer state and cache are DTensors on a ``torch.distributed`` device
mesh, placed by ``transformer.param_specs`` / ``cache_specs``
(``launch.mesh.distribute``); the step lays each plain input out over
``sh.batch`` and DTensor's sharding propagation (the twin of GSPMD)
places the rest, pinned where the reference pins it.  Plain tensors met
inside (positions, masks, the learning rate) count as replicated.
"""
from __future__ import annotations

import torch

import contextlib

from ..core.device import resolve_device
from ..core.tree import leaves, tree_map, unflatten
from . import layers, transformer
from .layers import NO_SHARD, P, Shardings

MOE_AUX_WEIGHT = 0.01


def _on(x, dev):
    return torch.as_tensor(x).to(dev)


def cross_entropy(logits, labels):
    """logits (B,S,V) any float dtype; labels (B,S) int -> scalar f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    if layers._is_dtensor(lf):
        # the gold logit as a masked sum over the (maybe sharded) vocab:
        # DTensor's vocab-parallel gather (a masked partial) fails at the
        # subtraction; every other term of the sum is exactly 0
        vocab = torch.arange(lf.shape[-1], device=lf.device)
        gold = torch.where(labels[..., None].long() == vocab, lf, 0).sum(-1)
    else:
        gold = torch.take_along_dim(lf, labels[..., None].long(),
                                    dim=-1)[..., 0]
    return (lse - gold).mean()


def _mesh_of(tree):
    """The device mesh of the first DTensor leaf of ``tree``, else None."""
    return next((t.device_mesh for t in leaves(tree)
                 if layers._is_dtensor(t)), None)


def _sharded(mesh):
    """The context a sharded step runs in: plain tensors count as
    replicated DTensors (``implicit_replication``); none without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _lay_out(batch: dict, mesh, sh: Shardings, dev) -> dict:
    """Each input on ``dev``; on a mesh, a DTensor whose dim 0 is split
    over ``sh.batch`` (an input that is one already is kept).  Every rank
    passes the same whole batch and keeps its rows."""
    out = {}
    for k, v in batch.items():
        if layers._is_dtensor(v):
            out[k] = v
            continue
        v = _on(v, dev)
        if mesh is not None:
            spec = P(sh.batch, *([None] * (v.dim() - 1))) if v.dim() else P()
            v = layers.Sharding(mesh, layers.placements(mesh, spec)).place(v)
        out[k] = v
    return out


def _serving(params):
    """``layers.serving_mode`` for a step on ``params``."""
    return layers.serving_mode(leaves(transformer.as_tree(params))[0])


def _plain(x):
    """A metric as a plain tensor (a DTensor gathered whole)."""
    return x.full_tensor() if layers._is_dtensor(x) else x


def pin(tree, mesh, specs):
    """Each DTensor leaf of ``tree`` laid out as its ``P`` in ``specs``
    (the reference's ``constrain_like_params``: gradients come out of the
    backward pass as DTensor propagates them, often partial sums)."""
    def one(t, s):
        want = layers.placements(mesh, s)
        if not layers._is_dtensor(t) or tuple(t.placements) == want:
            return t
        return t.redistribute(mesh, want)
    return tree_map(one, tree, specs)


def make_loss_fn(cfg, *, sh: Shardings = NO_SHARD):
    """(params, batch) -> (loss, {"ce", "moe_aux"}): the next-token cross
    entropy plus the MoE layers' load-balancing loss, weighted
    ``MOE_AUX_WEIGHT`` and averaged over layers."""
    def loss_fn(params, batch):
        logits, aux = transformer.forward(params, batch, cfg, sh=sh)
        ce = cross_entropy(logits, batch["labels"])
        loss = ce + MOE_AUX_WEIGHT * aux / max(cfg.n_layers, 1)
        return loss, {"ce": ce, "moe_aux": aux}
    return loss_fn


def make_grads_fn(cfg, *, sh: Shardings = NO_SHARD):
    """-> ``grads_of(params, batch) -> (loss, {"ce", "moe_aux"}, grads)``:
    the loss and its gradient against the bf16-cast tree, as the
    reference's ``make_train_step`` takes it (``grads_of``): the leaves of
    ``transformer.cast_params(params)`` (the float32 ones as they are) are
    made graph leaves, and the gradients, bf16 where the leaf is, are
    widened to float32.  The parameters themselves never require grad.

    On DTensor parameters (``sh``) the loss is taken whole (replicated)
    before the backward pass, and each gradient is laid out as its
    parameter (``pin`` with ``transformer.param_specs(cfg, sh)``)."""
    loss_fn = make_loss_fn(cfg, sh=sh)
    pspecs = transformer.param_specs(cfg, sh) if sh.enabled else None

    def grads_of(params, batch):
        pc = tree_map(lambda p: p.detach().requires_grad_(),
                      transformer.cast_params(params))
        mesh = _mesh_of(pc)
        with torch.enable_grad(), _sharded(mesh):
            loss, metrics = loss_fn(pc, batch)
            loss = layers.replicated(loss)
            gb = torch.autograd.grad(loss, leaves(pc))
        grads = unflatten(pc, list(gb))
        if mesh is not None and pspecs is not None:
            grads = pin(grads, mesh, pspecs)
        grads = tree_map(lambda g: g.float(), grads)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads
    return grads_of


def microbatch(batch: dict, m: int, M: int) -> dict:
    """Microbatch ``m`` of ``M``: rows m, m + M, m + 2M, ... (stride M, as
    the reference's ``make_train_step`` interleaves them, so that every
    data shard contributes rows to every microbatch).  A DTensor whose
    rows are split over the data shards is sliced shard by shard: with
    each shard's rows a multiple of M, its local rows m, m + M, ... are
    the microbatch's rows of that shard, and nothing moves."""
    return {k: _rows(v, m, M) for k, v in batch.items()}


def _rows(v, m: int, M: int):
    if not layers._is_dtensor(v) or all(
            getattr(pl, "dim", None) != 0 for pl in v.placements):
        return v[m::M]
    from torch.distributed.tensor import DTensor
    local = v.to_local()
    if local.shape[0] % M:
        raise ValueError(f"a data shard's {local.shape[0]} rows are not a "
                         f"multiple of num_microbatches={M}")
    return DTensor.from_local(local[m::M], v.device_mesh, v.placements,
                              run_check=False)


def make_train_step(cfg, optimizer, num_microbatches: int = 1,
                    acc_dtype=torch.float32, device=None, *,
                    sh: Shardings = NO_SHARD):
    """``optimizer``: a ``repro_torch.train.optimizer.Optimizer``.

    -> ``train_step(state, batch) -> (new_state, metrics)`` with ``state``
    = (params, opt_state, step): nested dicts of float32 tensors and a 0-d
    int32 step.  The step builds new tensors and writes none of its
    inputs, so it can be replayed on the same state.  ``metrics`` holds
    ``loss``, ``grad_norm``, ``ce`` and ``moe_aux`` as 0-d tensors.

    The gradient is ``make_grads_fn``'s.  ``num_microbatches`` M > 1
    accumulates the gradients of M microbatches (``microbatch``: rows at
    stride M) in ``acc_dtype``, so live activation memory scales 1/M
    while the math is the mean of the microbatches' gradients.

    ``sh``: the sharded step.  ``params`` and ``opt_state`` are DTensors
    placed by ``transformer.param_specs(cfg, sh)`` (Adafactor's by
    ``optimizer.adafactor_state_specs``), the batch is split over
    ``sh.batch``, the gradients are pinned to the parameters' layout, and
    the new state keeps it; the metrics come back whole."""
    grads_of = make_grads_fn(cfg, sh=sh)
    dev = resolve_device(device)
    M = num_microbatches

    def train_step(state, batch):
        params, opt_state, step = state
        params = transformer.as_tree(params)
        mesh = _mesh_of(params) if sh.enabled else None
        batch = _lay_out(batch, mesh, sh, dev)
        with _sharded(mesh):
            return _step(params, opt_state, step, batch)

    def _step(params, opt_state, step, batch):
        if M == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % M:
                raise ValueError(f"batch of {B} rows is not a multiple of "
                                 f"num_microbatches={M}")
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dtype),
                            params)
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
        metrics = {"loss": loss, "grad_norm": gnorm, **metrics}
        return (new_params, new_opt, step + 1), {
            k: _plain(v) for k, v in metrics.items()}

    return train_step


def make_eval_step(cfg, device=None, *, sh: Shardings = NO_SHARD):
    """-> ``eval_step(params, batch) -> {"loss", "ce", "moe_aux"}``, the
    loss without gradients (``layers.serving_mode``; past ``layers.ATTN_CHUNK_THRESHOLD`` the
    flash-attention kernel runs on the card)."""
    loss_fn = make_loss_fn(cfg, sh=sh)
    dev = resolve_device(device)

    def eval_step(params, batch):
        mesh = _mesh_of(transformer.as_tree(params)) if sh.enabled else None
        batch = _lay_out(batch, mesh, sh, dev)
        with _serving(params), _sharded(mesh):
            loss, metrics = loss_fn(params, batch)
        return {k: _plain(v) for k, v in dict(loss=loss, **metrics).items()}

    return eval_step


def make_prefill_step(cfg, device=None, *, sh: Shardings = NO_SHARD):
    """Full-sequence forward (the prefill_* cells). Returns last logits
    (a DTensor in a sharded step)."""
    dev = resolve_device(device)

    def prefill(params, batch):
        mesh = _mesh_of(transformer.as_tree(params)) if sh.enabled else None
        batch = _lay_out(batch, mesh, sh, dev)
        with _serving(params), _sharded(mesh):
            logits, _ = transformer.forward(params, batch, cfg,
                                            last_only=True, sh=sh)
            return logits[:, -1]
    return prefill


def make_serve_step(cfg, seq_shard_axes=(), device=None, *,
                    sh: Shardings = NO_SHARD):
    """One-token decode (the decode_* / long_* cells).  The cache is
    updated in place and returned.  ``seq_shard_axes``: the KV caches'
    sequence dim is sharded (``transformer.decode_step``)."""
    dev = resolve_device(device)

    def serve_step(params, cache, token, pos):
        mesh = _mesh_of(transformer.as_tree(params)) if sh.enabled else None
        token = _lay_out({"t": token}, mesh, sh, dev)["t"]
        with _sharded(mesh):
            logits, cache = transformer.decode_step(
                params, cache, token, pos, cfg,
                seq_shard_axes=seq_shard_axes, sh=sh)
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
