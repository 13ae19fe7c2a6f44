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
is a Python loop over the stacked axis.  ``forward`` takes gradients where
its caller does (the train step) and then, with ``cfg.remat``, recomputes
its layers in the backward pass as the reference's two-level remat does;
decoding runs under ``torch.inference_mode`` (``torch.no_grad`` on
DTensors).

The reference's sharding specs are here too: ``param_specs`` and
``cache_specs`` give each leaf's ``layers.P`` (keyed as ``init_params``'
and ``init_cache``'s trees), ``abstract_params`` the tree on ``meta``;
``forward`` and ``decode_step`` take a ``layers.Shardings`` (keyword
``sh``) and constrain the activations as the reference does.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..core.tree import leaves
from . import layers, ssm
from .layers import NO_SHARD, P, Shardings, compute_dtype

FAMILIES = ("dense", "encoder", "moe", "ssm", "hybrid")


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


class TransformerLM(nn.Module):
    """The parameter tree as a module: a nested dict of tensors becomes
    nested modules, so ``state_dict`` keys are the tree's dotted paths.
    Parameters do not require grad: the train step differentiates a cast
    copy of the tree (``lm.make_train_step``)."""

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
                cast: bool = False, device=None) -> TransformerLM:
    """Seeded random parameters with the reference's shapes and scales,
    drawn from ``generator`` on its device.  The reference draws from
    ``jax.random``: the numbers differ; ``convert.params_from_jax`` hands
    over its own.

    Each layer is drawn in float32 and written into stacked (L, ...)
    tensors allocated once.  ``cast``: the leaves ``cast_params`` casts
    are stored in bf16, the values it would give (the draws are the same
    float32 numbers, rounded once), so a model whose float32 weights
    would not fit the card (Moonlight-16B-A3B: 112 GB) is held in half.
    ``device``: where the tensors are made (default: the generator's;
    ``"meta"`` allocates nothing, ``abstract_params``)."""
    _check_family(cfg)
    device = generator.device if device is None else torch.device(device)
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


def abstract_params(cfg) -> dict:
    """The parameter tree as ``meta`` tensors: the shapes and dtypes of
    ``init_params``, no allocation (the dry run's parameters)."""
    return init_params(cfg, torch.Generator(), device="meta").tree()


# ------------------------------------------------------- sharding specs
# Parameters shard 2-D: TP over ``model`` (output/contract dims) x ZeRO-3
# over ``fsdp`` (the other large dim), the reference's layout.  DTensor's
# propagation gathers the fsdp shards at use and reduce-scatters the
# gradients back; optimizer state stays fully sharded.
def _attn_specs(cfg, sh: Shardings, prefix=()):
    m, f = sh.model, sh.fsdp
    pre = lambda s: P(*(prefix + tuple(s)))
    out = {"wq": pre((f, m)), "wk": pre((f, m)), "wv": pre((f, m)),
           "wo": pre((m, f))}
    if cfg.qk_norm:
        out["q_norm"] = pre((None,))
        out["k_norm"] = pre((None,))
    return out


def _norm_specs(cfg, prefix=()):
    if cfg.norm == "ln_nonparam":
        return {}
    return {"scale": P(*(prefix + (None,)))}


def _block_specs(cfg, sh: Shardings):
    m, f = sh.model, sh.fsdp
    pre = (None,)  # stacked layer axis
    if cfg.family in ("dense", "encoder"):
        return {"ln1": _norm_specs(cfg, pre),
                "attn": _attn_specs(cfg, sh, pre),
                "ln2": _norm_specs(cfg, pre),
                "mlp": {"wi": P(None, f, m), "wg": P(None, f, m),
                        "wo": P(None, m, f)}}
    if cfg.family == "moe":
        return {"ln1": _norm_specs(cfg, pre),
                "attn": _attn_specs(cfg, sh, pre),
                "ln2": _norm_specs(cfg, pre),
                "moe": {"router": P(None, f, None),
                        "wi": P(None, m, f, None),
                        "wg": P(None, m, f, None),
                        "wo": P(None, m, None, f)}}
    if cfg.family == "ssm":
        return {"ln1": _norm_specs(cfg, pre),
                "mamba": {"in_proj": P(None, f, m),
                          "conv_w": P(None, None, m),
                          "conv_b": P(None, m),
                          "x_proj": P(None, m, f),
                          "dt_proj": P(None, f, m),
                          "dt_bias": P(None, m),
                          "A_log": P(None, m, None),
                          "D": P(None, m),
                          "out_proj": P(None, m, f)}}
    if cfg.family == "hybrid":
        return {"ln1": _norm_specs(cfg, pre),
                "mamba": {"in_proj": P(None, f, m),
                          "conv_w": P(None, None, None),
                          "conv_b": P(None, None),
                          "dt_bias": P(None, None),
                          "A_log": P(None, None),
                          "D": P(None, None),
                          "norm_scale": P(None, m),
                          "out_proj": P(None, m, f)}}
    raise ValueError(cfg.family)


def param_specs(cfg, sh: Shardings) -> dict:
    """The ``P`` of every parameter, keyed as ``init_params``' tree."""
    m, f = sh.model, sh.fsdp
    vocab_m = sh.maybe_model(cfg.vocab_size)  # hubert's 504 stays unsharded
    specs = {
        "blocks": _block_specs(cfg, sh),
        "final_norm": _norm_specs(cfg),
        "lm_head": P(f, vocab_m if vocab_m else None),
    }
    if cfg.input_kind == "tokens":
        # column-sharded: row gather stays local; the vocab axis is
        # sharded only at the unembed
        specs["embed"] = P(f, m)
    if cfg.family == "hybrid":
        specs["shared_attn"] = {"ln": _norm_specs(cfg),
                                "attn": _attn_specs(cfg, sh)}
    return specs


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


def _unstack(blocks, n: int) -> list:
    """The stacked (n, ...) block tensors as n per-layer trees of views
    (one ``unbind`` a leaf, whose backward stacks the layers' gradients
    once)."""
    per = [{} for _ in range(n)]

    def walk(src, dsts):
        for k, v in src.items():
            if isinstance(v, dict):
                walk(v, [d.setdefault(k, {}) for d in dsts])
            else:
                for d, t in zip(dsts, v.unbind(0)):
                    d[k] = t
    walk(blocks, per)
    return per


def _block_fwd(x, pl, cfg, sh: Shardings = NO_SHARD):
    """One layer. Returns (x, aux).  Its weights' fsdp shards are
    gathered at use (``Shardings.gather``)."""
    pl = sh.gather(pl)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.apply_norm(x, pl["ln1"], cfg.norm)
    if cfg.family in ("dense", "encoder", "moe"):
        x = x + layers.attention(h, pl["attn"], cfg, causal=cfg.causal,
                                 sh=sh)
        h = layers.apply_norm(x, pl["ln2"], cfg.norm)
        if cfg.family == "moe":
            y, aux = layers.moe(h, pl["moe"], cfg, sh=sh)
            x = x + y
        else:
            x = x + layers.mlp(h, pl["mlp"], sh=sh)
    elif cfg.family == "ssm":
        x = x + ssm.mamba1_block(h, pl["mamba"], cfg, sh=sh)
    elif cfg.family == "hybrid":
        x = x + ssm.mamba2_block(h, pl["mamba"], cfg, sh=sh)
    return x, aux


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    instead of kept (``jax.checkpoint`` with ``nothing_saveable``).  The
    forward draws no random numbers, so the RNG state is not stashed."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _seq(x, aux, layer_trees, cfg, remat: bool, sh: Shardings = NO_SHARD):
    """The layers one after the other, each recomputed in the backward pass
    where ``remat``.  -> (x, aux + the layers' aux).  With ``sh.seq`` the
    carry is sequence-sharded between layers (sequence parallelism)."""
    for pl in layer_trees:
        if sh.seq:
            x = sh.constrain(x, sh.batch, sh.seq, None)
        x, a = _remat(_block_fwd, x, pl, cfg, sh) if remat else _block_fwd(
            x, pl, cfg, sh)
        aux = aux + a
    return x, aux


def _scan_blocks(x, layer_trees, cfg, grad: bool, sh: Shardings = NO_SHARD):
    """The depth loop with the reference's sqrt(L) two-level remat
    (``repro/models/transformer.py::_scan_blocks``), where ``cfg.remat``
    and ``grad`` (autograd records the forward): every layer is
    recomputed in the backward pass and, from 16 layers, segments of
    round(sqrt(L)) layers (and the rest as one more) are too, so that only
    the segments' inputs are kept for the backward pass and one segment's
    layer inputs at a time.  Without gradients there is no backward pass,
    and the layers simply run.  -> (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    L = len(layer_trees)
    remat = cfg.remat and grad
    if not remat or L < 16:
        return _seq(x, aux, layer_trees, cfg, remat, sh)
    s = max(int(L ** 0.5 + 0.5), 1)
    k = L // s
    for j in range(k):
        x, aux = _remat(_seq, x, aux, layer_trees[j * s:(j + 1) * s], cfg,
                        True, sh)
    if L - k * s:
        x, aux = _remat(_seq, x, aux, layer_trees[k * s:], cfg, True, sh)
    return x, aux


def _embed(table, tokens):
    """Rows ``tokens`` of ``table``.  On a DTensor table each rank gathers
    its own tokens' rows of its own columns (``local_map``): the table is
    taken whole on every mesh dim but the one that splits its columns
    (and whole there too if the tokens are split on it), the output is
    split as the tokens' rows and the table's columns are, and the
    table's gradient is a partial sum over the ranks whose tokens
    differ.  (DTensor's own index rule needs no redistribution, but its
    backward ``index_put`` failed on the card's torch.)"""
    if not layers._is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    if not layers._is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)
    tok = tuple(Shard(0) if pl == Shard(0) else Replicate()
                for pl in tokens.placements)
    tab = tuple(Shard(1) if pl == Shard(1) and t != Shard(0) else Replicate()
                for pl, t in zip(table.placements, tok))
    out = tuple(Shard(0) if t == Shard(0) else Shard(2) if c == Shard(1)
                else Replicate() for t, c in zip(tok, tab))
    grad = tuple(Partial() if t == Shard(0) else c
                 for t, c in zip(tok, tab))
    return local_map(lambda t, i: t[i], out_placements=list(out),
                     in_placements=(list(tab), list(tok)),
                     in_grad_placements=(list(grad), list(tok)),
                     device_mesh=mesh, redistribute_inputs=True)(table,
                                                                 tokens)


def _shared_attn(x, p, cfg, sh: Shardings = NO_SHARD):
    p = sh.gather(p)
    h = layers.apply_norm(x, p["ln"], cfg.norm)
    return x + layers.attention(h, p["attn"], cfg, causal=cfg.causal, sh=sh)


def _sites(cfg) -> int:
    """Shared-attention sites of a hybrid (one after every ``attn_every``
    Mamba layers), else 0."""
    if cfg.family == "hybrid" and cfg.attn_every:
        return cfg.n_layers // cfg.attn_every
    return 0


def forward(params, batch, cfg, last_only: bool = False, *,
            sh: Shardings = NO_SHARD):
    """Training / prefill forward pass -> (logits, aux); aux is the MoE
    layers' load-balancing loss summed over layers (0 for the other
    families).  Gradients flow where the caller enables them and the
    parameters given require them (``lm.make_train_step``).

    A hybrid runs its layers as the reference does: ``_scan_blocks`` over
    each run of ``attn_every`` Mamba layers, the shared attention block
    after it outside any remat.

    ``last_only``: unembed only the final position (prefill serving) — the
    (B, S, V) logits tensor is never materialized.

    ``sh``: on DTensor parameters and inputs (``lm``'s sharded steps),
    the activations are constrained as the reference constrains them."""
    _check_family(cfg)
    params = cast_params(params)
    if cfg.input_kind == "tokens":
        x = _embed(compute_dtype(sh.gather(params["embed"])),
                   batch["tokens"])
    else:
        x = batch["embeds"].to(torch.bfloat16)
    x = sh.constrain(x, sh.batch, None, None)
    per_layer = _unstack(params["blocks"], cfg.n_layers)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in leaves(params))
    run = cfg.attn_every if _sites(cfg) else cfg.n_layers
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(0, cfg.n_layers, run):
        x, a = _scan_blocks(x, per_layer[s:s + run], cfg, grad, sh)
        aux = aux + a
        if _sites(cfg) and s + run <= cfg.n_layers:
            x = _shared_attn(x, params["shared_attn"], cfg, sh)
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    if last_only:
        x = x[:, -1:]
    logits = layers._mm(x, compute_dtype(sh.gather(params["lm_head"])))
    return sh.constrain(logits, sh.batch, None, sh.model), aux



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


def cache_specs(cfg, sh: Shardings, seq_shard_axes: Sequence[str] = (),
                kv_quant: bool = False) -> dict:
    """The ``P`` of every leaf of ``init_cache``'s tree.

    KV caches shard on the kv-head axis when the head count divides the
    model axis; otherwise the *sequence* axis takes the model axis
    (distributed flash-decode).  ``seq_shard_axes`` (long_500k) forces
    sequence sharding on those axes.
    """
    seq = tuple(seq_shard_axes) if seq_shard_axes else None
    heads = sh.maybe_model(cfg.n_kv_heads) if cfg.n_kv_heads else ()
    if seq is None and not heads and sh.model:
        seq = sh.model
    kvspec = P(None, sh.batch if not seq_shard_axes else None, seq,
               heads if heads else None, None)
    if cfg.family in ("dense", "moe", "encoder"):
        d = {"attn": {"k": kvspec, "v": kvspec}}
        if kv_quant:
            d["attn"]["k_scale"] = kvspec
            d["attn"]["v_scale"] = kvspec
        return d
    if cfg.family == "ssm":
        return {"ssm": {"h": P(None, sh.batch, sh.model, None),
                        "conv": P(None, sh.batch, None, sh.model)}}
    if cfg.family == "hybrid":
        c = {"ssm": {"h": P(None, sh.batch, None, None, None),
                     "conv": P(None, sh.batch, None, None)}}
        if cfg.attn_every:
            c["attn"] = {"k": kvspec, "v": kvspec}
        return c
    raise ValueError(cfg.family)


def _block_decode(x, pl, cache_l, pos, cfg, seq_shard_axes,
                  sh: Shardings = NO_SHARD):
    """One layer of decode; the layer's cache rows are updated in place.
    -> x."""
    pl = sh.gather(pl)
    h = layers.apply_norm(x, pl["ln1"], cfg.norm)
    if cfg.family in ("dense", "moe", "encoder"):
        a, _ = layers.decode_attention(h, pl["attn"], cfg, cache_l["attn"],
                                       pos, seq_shard_axes=seq_shard_axes,
                                       sh=sh)
        x = x + a
        h = layers.apply_norm(x, pl["ln2"], cfg.norm)
        if cfg.family == "moe":
            # decode batches are tiny: provision full capacity (no drops)
            y, _ = layers.moe(h, pl["moe"], cfg,
                              capacity_factor=cfg.n_experts / cfg.top_k,
                              sh=sh)
        else:
            y = layers.mlp(h, pl["mlp"], sh=sh)
        return x + y
    step = ssm.mamba1_decode if cfg.family == "ssm" else ssm.mamba2_decode
    y, st = step(h, pl["mamba"], cfg, cache_l["ssm"], sh=sh)
    for name, t in st.items():
        cache_l["ssm"][name].copy_(t)
    return x + y


def decode_step(params, cache, token, pos: int, cfg,
                seq_shard_axes=(), *, sh: Shardings = NO_SHARD):
    """One-token decode. token (B, 1) int (or embeds (B, 1, D)); pos an int.

    Returns (logits (B, 1, V), cache), the cache updated in place.
    ``seq_shard_axes``: the KV caches' sequence dim is sharded
    (``layers.decode_attention``): mesh axis names (the group form, the
    caches DTensors sharded over them) or an int N (the local form, N
    shards of each cache on this device); at every attention layer and
    every shared-attention site of a hybrid.  Runs under
    ``layers.serving_mode``."""
    _check_family(cfg)
    with layers.serving_mode(leaves(as_tree(params))[0], *leaves(cache)):
        return _decode_step(params, cache, token, pos, cfg, seq_shard_axes,
                            sh)


def _decode_step(params, cache, token, pos, cfg, seq_shard_axes, sh):
    params = cast_params(params)
    if cfg.input_kind == "tokens":
        x = _embed(compute_dtype(sh.gather(params["embed"])), token)
    else:
        x = token.to(torch.bfloat16)
    x = sh.constrain(x, sh.batch, None, None)
    layer_cache = {k: v for k, v in cache.items()
                   if not (k == "attn" and _sites(cfg))}
    for i in range(cfg.n_layers):
        x = _block_decode(x, _layer(params["blocks"], i),
                          _layer(layer_cache, i), pos, cfg, seq_shard_axes,
                          sh)
        if _sites(cfg) and (i + 1) % cfg.attn_every == 0:
            site = (i + 1) // cfg.attn_every - 1
            shared = sh.gather(params["shared_attn"])
            h = layers.apply_norm(x, shared["ln"], cfg.norm)
            a, _ = layers.decode_attention(
                h, shared["attn"], cfg, _layer(cache["attn"], site), pos,
                seq_shard_axes=seq_shard_axes, sh=sh)
            x = x + a
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    logits = layers._mm(x, compute_dtype(sh.gather(params["lm_head"])))
    return sh.constrain(logits, sh.batch, None, sh.model), cache
