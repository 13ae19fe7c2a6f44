"""Model assembly on torch tensors: init, forward (prefill), decode.

The ``dense`` and ``encoder`` families of the reference's
``models/transformer.py``, with its parameter layout:

  params = {
    "embed"      : (V, D)                 [tokens archs]
    "blocks"     : per-layer dicts stacked on a leading layer axis (L, ...)
    "final_norm" : norm params
    "lm_head"    : (D, V)
  }

``TransformerLM`` holds that tree as an ``nn.Module`` whose parameter names
are the tree's paths joined by dots (``blocks.attn.wq`` is (L, D, H*hd)).
Every function takes the module or the plain nested dict.  The layer scan
is a Python loop over the stacked axis, under ``torch.inference_mode``.
The ``moe``, ``ssm`` and ``hybrid`` families raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.device import resolve_device
from . import layers
from .layers import compute_dtype

_WAITING = {
    "moe": "the moe family (models/layers.py MoE) is not ported yet: "
           "ROADMAP Queue 1 item 11",
    "ssm": "the ssm family (models/ssm.py) is not ported yet: "
           "ROADMAP Queue 1 item 11",
    "hybrid": "the hybrid family (models/ssm.py) is not ported yet: "
              "ROADMAP Queue 1 item 11",
}


def _check_family(cfg) -> None:
    if cfg.family in _WAITING:
        raise NotImplementedError(_WAITING[cfg.family])
    if cfg.family not in ("dense", "encoder"):
        raise ValueError(cfg.family)


class TransformerLM(nn.Module):
    """The parameter tree as a module: a nested dict of tensors becomes
    nested modules, so ``state_dict`` keys are the tree's dotted paths.
    Parameters do not require grad (serving only)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, sub in tree.items():
            if isinstance(sub, dict):
                self.add_module(name, TransformerLM(sub))
            else:
                self.register_parameter(
                    name, nn.Parameter(sub, requires_grad=False))

    def tree(self) -> dict:
        """The nested dict of parameter tensors (no copies)."""
        out = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


def as_tree(params) -> dict:
    return params.tree() if isinstance(params, TransformerLM) else params


# ------------------------------------------------------------------ init
def _init_block(generator, cfg, device):
    return {"ln1": layers.init_norm(generator, cfg.d_model, cfg.norm, device),
            "attn": layers.init_attention(generator, cfg, device),
            "ln2": layers.init_norm(generator, cfg.d_model, cfg.norm, device),
            "mlp": layers.init_mlp(generator, cfg, device)}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg, generator: torch.Generator) -> TransformerLM:
    """Seeded random parameters with the reference's shapes and scales,
    drawn from ``generator`` on its device.  The reference draws from
    ``jax.random``: the numbers differ; ``convert.params_from_jax`` hands
    over its own."""
    _check_family(cfg)
    device = generator.device
    blocks = _stack([_init_block(generator, cfg, device)
                     for _ in range(cfg.n_layers)])
    params = {
        "blocks": blocks,
        "final_norm": layers.init_norm(generator, cfg.d_model, cfg.norm,
                                       device),
        "lm_head": layers._normal(generator, (cfg.d_model, cfg.vocab_size),
                                  device) / (cfg.d_model ** 0.5),
    }
    if cfg.input_kind == "tokens":
        params["embed"] = layers._normal(
            generator, (cfg.vocab_size, cfg.d_model), device) * 0.02
    return TransformerLM(params)


# ------------------------------------------------------------- forward
_KEEP_F32 = {"A_log", "dt_bias", "conv_b", "D", "scale", "norm_scale",
             "q_norm", "k_norm", "router"}


def cast_params(params) -> dict:
    """bf16-cast the large matrices; precision-sensitive leaves stay f32.
    Leaves already cast are kept, so casting twice costs nothing."""
    def cast(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = cast(leaf)
            elif name in _KEEP_F32 or leaf.dtype != torch.float32:
                out[name] = leaf
            else:
                out[name] = leaf.to(torch.bfloat16)
        return out
    return cast(as_tree(params))


def _layer(blocks, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def _block_fwd(x, pl, cfg):
    """One layer. Returns (x, aux)."""
    h = layers.apply_norm(x, pl["ln1"], cfg.norm)
    x = x + layers.attention(h, pl["attn"], cfg, causal=cfg.causal)
    h = layers.apply_norm(x, pl["ln2"], cfg.norm)
    x = x + layers.mlp(h, pl["mlp"])
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


@torch.inference_mode()
def forward(params, batch, cfg, last_only: bool = False):
    """Prefill forward pass -> (logits, aux).

    ``last_only``: unembed only the final position (prefill serving) — the
    (B, S, V) logits tensor is never materialized."""
    _check_family(cfg)
    params = cast_params(params)
    if cfg.input_kind == "tokens":
        x = compute_dtype(params["embed"])[batch["tokens"]]
    else:
        x = batch["embeds"].to(torch.bfloat16)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = _block_fwd(x, _layer(params["blocks"], i), cfg)
        aux = aux + a
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    if last_only:
        x = x[:, -1:]
    logits = layers._mm(x, compute_dtype(params["lm_head"]))
    return logits, aux


# ------------------------------------------------------------- serving
def init_cache(cfg, batch: int, max_seq: int, kv_quant: bool = False,
               device=None):
    """Per-layer decode state, stacked on the layer axis.

    ``kv_quant``: int8 KV cache + per-(token, head) f32 scales.  ``device``
    None means the card (``core.device.resolve_device``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    shp = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    if kv_quant:
        sshp = shp[:-1] + (1,)
        return {"attn": {
            "k": torch.zeros(shp, dtype=torch.int8, device=dev),
            "v": torch.zeros(shp, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(sshp, dtype=torch.float32, device=dev),
            "v_scale": torch.zeros(sshp, dtype=torch.float32, device=dev)}}
    return {"attn": {
        "k": torch.zeros(shp, dtype=torch.bfloat16, device=dev),
        "v": torch.zeros(shp, dtype=torch.bfloat16, device=dev)}}


def _block_decode(x, pl, cache_l, pos, cfg, seq_shard_axes):
    h = layers.apply_norm(x, pl["ln1"], cfg.norm)
    a, kv = layers.decode_attention(h, pl["attn"], cfg, cache_l["attn"], pos,
                                    seq_shard_axes=seq_shard_axes)
    x = x + a
    h = layers.apply_norm(x, pl["ln2"], cfg.norm)
    x = x + layers.mlp(h, pl["mlp"])
    return x, {"attn": kv}


@torch.inference_mode()
def decode_step(params, cache, token, pos: int, cfg,
                seq_shard_axes: Sequence[str] = ()):
    """One-token decode. token (B, 1) int (or embeds (B, 1, D)); pos an int.

    Returns (logits (B, 1, V), cache), the cache updated in place."""
    _check_family(cfg)
    params = cast_params(params)
    if cfg.input_kind == "tokens":
        x = compute_dtype(params["embed"])[token]
    else:
        x = token.to(torch.bfloat16)
    for i in range(cfg.n_layers):
        x, _ = _block_decode(x, _layer(params["blocks"], i),
                             _layer(cache, i), pos, cfg, seq_shard_axes)
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    logits = layers._mm(x, compute_dtype(params["lm_head"]))
    return logits, cache
