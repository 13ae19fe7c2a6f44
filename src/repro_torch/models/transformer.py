"""Model assembly on torch tensors: init, forward (prefill), decode.

The reference's ``models/transformer.py`` for every family (dense, encoder,
moe, ssm, hybrid), with its parameter layout:

  params = {
    "embed"      : (V, D)                 [tokens archs]
    "blocks"     : per-layer dicts stacked on a leading layer axis (L, ...)
    "shared_attn": {"ln", "attn"}          [hybrid only, ONE copy]
    "final_norm" : norm params
    "lm_head"    : (D, V)
  }

``TransformerLM`` holds that tree as an ``nn.Module`` whose parameter names
are the tree's paths joined by dots (``blocks.attn.wq`` is (L, D, H*hd)).
Every function takes the module or the plain nested dict.  The layer scan
is a Python loop over the stacked axis, under ``torch.inference_mode``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.device import resolve_device
from . import layers, ssm
from .layers import compute_dtype

FAMILIES = ("dense", "encoder", "moe", "ssm", "hybrid")


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
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
    def norm():
        return layers.init_norm(generator, cfg.d_model, cfg.norm, device)
    if cfg.family in ("dense", "encoder", "moe"):
        block = {"ln1": norm(),
                 "attn": layers.init_attention(generator, cfg, device),
                 "ln2": norm()}
        if cfg.family == "moe":
            block["moe"] = layers.init_moe(generator, cfg, device)
        else:
            block["mlp"] = layers.init_mlp(generator, cfg, device)
        return block
    if cfg.family == "ssm":
        return {"ln1": norm(), "mamba": ssm.init_mamba1(generator, cfg,
                                                        device)}
    if cfg.family == "hybrid":
        return {"ln1": norm(), "mamba": ssm.init_mamba2(generator, cfg,
                                                        device)}
    raise ValueError(cfg.family)


def _put_layer(stack: dict, tree: dict, i: int, n: int, cast: bool):
    """Write one layer's ``tree`` into row ``i`` of the (n, ...) tensors of
    ``stack``, allocating each on its first layer (in bf16 where ``cast``
    and ``cast_params`` would cast the leaf)."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _put_layer(stack.setdefault(name, {}), leaf, i, n, cast)
            continue
        if name not in stack:
            bf16 = (cast and name not in _KEEP_F32
                    and leaf.dtype == torch.float32)
            stack[name] = torch.empty(
                (n,) + tuple(leaf.shape), device=leaf.device,
                dtype=torch.bfloat16 if bf16 else leaf.dtype)
        stack[name][i].copy_(leaf)


def init_params(cfg, generator: torch.Generator, *,
                cast: bool = False) -> TransformerLM:
    """Seeded random parameters with the reference's shapes and scales,
    drawn from ``generator`` on its device.  The reference draws from
    ``jax.random``: the numbers differ; ``convert.params_from_jax`` hands
    over its own.

    Each layer is drawn in float32 and written into stacked (L, ...)
    tensors allocated once.  ``cast``: the leaves ``cast_params`` casts
    are stored in bf16, the values it would give (the draws are the same
    float32 numbers, rounded once), so a model whose float32 weights
    would not fit the card (Moonlight-16B-A3B: 112 GB) is held in half."""
    _check_family(cfg)
    device = generator.device
    blocks: dict = {}
    for i in range(cfg.n_layers):
        _put_layer(blocks, _init_block(generator, cfg, device), i,
                   cfg.n_layers, cast)
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
    if cfg.family == "hybrid":
        params["shared_attn"] = {
            "ln": layers.init_norm(generator, cfg.d_model, cfg.norm, device),
            "attn": layers.init_attention(generator, cfg, device)}
    return TransformerLM(cast_params(params) if cast else params)


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
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.apply_norm(x, pl["ln1"], cfg.norm)
    if cfg.family in ("dense", "encoder", "moe"):
        x = x + layers.attention(h, pl["attn"], cfg, causal=cfg.causal)
        h = layers.apply_norm(x, pl["ln2"], cfg.norm)
        if cfg.family == "moe":
            y, aux = layers.moe(h, pl["moe"], cfg)
            x = x + y
        else:
            x = x + layers.mlp(h, pl["mlp"])
    elif cfg.family == "ssm":
        x = x + ssm.mamba1_block(h, pl["mamba"], cfg)
    elif cfg.family == "hybrid":
        x = x + ssm.mamba2_block(h, pl["mamba"], cfg)
    return x, aux


def _shared_attn(x, p, cfg):
    h = layers.apply_norm(x, p["ln"], cfg.norm)
    return x + layers.attention(h, p["attn"], cfg, causal=cfg.causal)


def _sites(cfg) -> int:
    """Shared-attention sites of a hybrid (one after every ``attn_every``
    Mamba layers), else 0."""
    if cfg.family == "hybrid" and cfg.attn_every:
        return cfg.n_layers // cfg.attn_every
    return 0


@torch.inference_mode()
def forward(params, batch, cfg, last_only: bool = False):
    """Prefill forward pass -> (logits, aux); aux is the MoE layers'
    load-balancing loss summed over layers (0 for the other families).

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
        if _sites(cfg) and (i + 1) % cfg.attn_every == 0:
            x = _shared_attn(x, params["shared_attn"], cfg)
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    if last_only:
        x = x[:, -1:]
    logits = layers._mm(x, compute_dtype(params["lm_head"]))
    return logits, aux


# ------------------------------------------------------------- serving
def init_cache(cfg, batch: int, max_seq: int, kv_quant: bool = False,
               device=None):
    """Per-layer decode state, stacked on the layer axis: the attention
    families' KV cache, the ssm family's Mamba-1 state, the hybrid's
    Mamba-2 state and one KV cache a shared-attention site.

    ``kv_quant``: int8 KV cache + per-(token, head) f32 scales (the
    attention families').  ``device`` None means the card
    (``core.device.resolve_device``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    L = cfg.n_layers

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv(n):
        shp = (n, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        if kv_quant:
            sshp = shp[:-1] + (1,)
            return {"k": zeros(shp, torch.int8), "v": zeros(shp, torch.int8),
                    "k_scale": zeros(sshp, torch.float32),
                    "v_scale": zeros(sshp, torch.float32)}
        return {"k": zeros(shp, torch.bfloat16),
                "v": zeros(shp, torch.bfloat16)}
    if cfg.family in ("dense", "moe", "encoder"):
        return {"attn": kv(L)}
    if cfg.family == "ssm":
        return {"ssm": {
            "h": zeros((L, batch, cfg.ssm_d_inner, cfg.ssm_state),
                       torch.float32),
            "conv": zeros((L, batch, cfg.ssm_conv - 1, cfg.ssm_d_inner),
                          torch.bfloat16)}}
    di2 = cfg.ssm_d_inner + 2 * cfg.ssm_state
    c = {"ssm": {
        "h": zeros((L, batch, cfg.ssm_heads,
                    cfg.ssm_d_inner // cfg.ssm_heads, cfg.ssm_state),
                   torch.float32),
        "conv": zeros((L, batch, cfg.ssm_conv - 1, di2), torch.bfloat16)}}
    if _sites(cfg):
        shp = (_sites(cfg), batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        c["attn"] = {"k": zeros(shp, torch.bfloat16),
                     "v": zeros(shp, torch.bfloat16)}
    return c


def _block_decode(x, pl, cache_l, pos, cfg, seq_shard_axes):
    """One layer of decode; the layer's cache rows are updated in place.
    -> x."""
    h = layers.apply_norm(x, pl["ln1"], cfg.norm)
    if cfg.family in ("dense", "moe", "encoder"):
        a, _ = layers.decode_attention(h, pl["attn"], cfg, cache_l["attn"],
                                       pos, seq_shard_axes=seq_shard_axes)
        x = x + a
        h = layers.apply_norm(x, pl["ln2"], cfg.norm)
        if cfg.family == "moe":
            # decode batches are tiny: provision full capacity (no drops)
            y, _ = layers.moe(h, pl["moe"], cfg,
                              capacity_factor=cfg.n_experts / cfg.top_k)
        else:
            y = layers.mlp(h, pl["mlp"])
        return x + y
    step = ssm.mamba1_decode if cfg.family == "ssm" else ssm.mamba2_decode
    y, st = step(h, pl["mamba"], cfg, cache_l["ssm"])
    for name, t in st.items():
        cache_l["ssm"][name].copy_(t)
    return x + y


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
    layer_cache = {k: v for k, v in cache.items()
                   if not (k == "attn" and _sites(cfg))}
    for i in range(cfg.n_layers):
        x = _block_decode(x, _layer(params["blocks"], i),
                          _layer(layer_cache, i), pos, cfg, seq_shard_axes)
        if _sites(cfg) and (i + 1) % cfg.attn_every == 0:
            site = (i + 1) // cfg.attn_every - 1
            shared = params["shared_attn"]
            h = layers.apply_norm(x, shared["ln"], cfg.norm)
            a, _ = layers.decode_attention(
                h, shared["attn"], cfg, _layer(cache["attn"], site), pos,
                seq_shard_axes=seq_shard_axes)
            x = x + a
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    logits = layers._mm(x, compute_dtype(params["lm_head"]))
    return logits, cache
