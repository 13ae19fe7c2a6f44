"""Transformer building blocks on torch tensors: the reference's
``models/layers.py``, name for name (``Shardings``, norms, RoPE, attention,
MLP, MoE).

Conventions, as in the reference:
  * params are plain dicts of tensors; fp32 storage, bf16 compute;
  * every function takes a ``Shardings`` (keyword ``sh``) so that
    activation constraints follow whatever mesh (('data','model') or
    ('pod','data','model')) the tensors live on: on DTensors a constraint
    is a ``redistribute``, on plain tensors it does nothing;
  * attention supports GQA, RoPE (with a position offset for decode),
    optional qk-norm (Qwen3), causal/bidirectional, and a KV-cache decode
    path (bf16 or int8 cache) with an optional *sequence-sharded* cache
    (distributed flash-decode: local softmax stats and a combine over the
    shards) for the long-context cells.

Long-sequence attention (S > ``ATTN_CHUNK_THRESHOLD``) runs
``kernels.ops.flash_attention``: on CUDA tensors the Hopper kernel, on CPU
tensors ``_sdpa_chunked`` (``core.attention``, re-exported here), which is
the kernel's plain version and computes what the reference computes there.
On DTensors the kernel runs on each rank's heads (``local_map``).  With
gradients on, it takes the gradient route instead (``attention``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.attention import NEG, _sdpa_chunked  # noqa: F401
from ..kernels import ops


# ------------------------------------------------------------- shardings
def _axis_entry(entry):
    """One dim of a spec as jax's ``PartitionSpec`` holds it: None for no
    axis (None or ()), the name for one axis, a tuple for several."""
    if entry is None or entry == ():
        return None
    if isinstance(entry, str):
        return entry
    entry = tuple(entry)
    return entry[0] if len(entry) == 1 else entry


class P(tuple):
    """A partition spec: per tensor dim, the mesh axes it is sharded over
    (None: replicated), entries normalised as the reference's
    ``PartitionSpec`` normalises them, so ``tuple(P(...))`` is the
    reference's ``tuple(PartitionSpec(...))``.  A leaf of ``core.tree``."""
    tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, (_axis_entry(e) for e in entries))

    def __repr__(self):
        return "P" + tuple.__repr__(self)


def placements(mesh, spec: P) -> tuple:
    """DTensor placements on ``mesh`` (a ``DeviceMesh`` with dim names) of
    a tensor laid out as ``spec``: ``Shard(d)`` on each mesh dim that
    tensor dim ``d`` names, ``Replicate()`` on the others.  A dim named by
    two mesh dims (a batch over ("pod", "data")) is split over both, the
    earlier mesh dim outermost.  Raises ValueError on an axis the mesh
    lacks or one named twice."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names or ()
    out = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        for name in (() if entry is None else
                     (entry,) if isinstance(entry, str) else entry):
            if name not in names:
                raise ValueError(f"mesh axes {names} have no {name!r}")
            i = names.index(name)
            if out[i] != Replicate():
                raise ValueError(f"axis {name!r} named twice in {spec}")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives: DTensor ``placements`` on ``mesh`` (the twin
    of the reference's ``NamedSharding``).  A leaf of ``core.tree``."""
    mesh: object
    placements: tuple

    def place(self, t: torch.Tensor):
        """``t``, the whole tensor (the same on every rank), as a DTensor
        laid out so: each rank keeps its own shard, nothing moves."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh, self.placements,
                                 src_data_rank=None)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


@dataclasses.dataclass(frozen=True)
class Shardings:
    """Logical->mesh axis mapping. Empty tuples mean 'replicated'.

    ``fsdp`` names the mesh axes that additionally shard *parameters*
    (ZeRO-3: weights gathered at use, optimizer state stays sharded) —
    typically the data axis.  ``model_size`` is the model-axis extent, used
    to drop head-axis constraints when head counts don't divide it.
    """
    batch: tuple = ("data",)     # ('pod','data') on the multi-pod mesh
    model: tuple = ("model",)
    fsdp: tuple = ()
    seq: tuple = ()              # sequence-parallel carries (perf variant)
    model_size: int = 1
    enabled: bool = True

    def spec(self, *axes) -> P:
        return P(*[a if a else None for a in axes])

    def maybe_model(self, n: int) -> tuple:
        """Model axes only if ``n`` divides evenly (e.g. few KV heads)."""
        if self.model and self.model_size > 1 and n % self.model_size != 0:
            return ()
        return self.model

    def gather(self, tree):
        """The parameter leaves of ``tree`` with their ``fsdp`` shards
        gathered (ZeRO-3: weights whole at use on each data rank, their
        model sharding kept; the gradient of the gather reduce-scatters
        back onto the shards).  Plain tensors, and every leaf when
        disabled, come back as they are."""
        if not self.enabled or not self.fsdp:
            return tree
        from torch.distributed.tensor import Replicate

        def one(t):
            if not _is_dtensor(t):
                return t
            names = t.device_mesh.mesh_dim_names
            want = tuple(Replicate() if names[i] in self.fsdp else pl
                         for i, pl in enumerate(t.placements))
            if want == tuple(t.placements):
                return t
            return t.redistribute(t.device_mesh, want)
        if isinstance(tree, dict):
            return {k: self.gather(v) for k, v in tree.items()}
        return one(tree)

    def constrain(self, x, *axes):
        """``x`` laid out as ``spec(*axes)``: a ``redistribute`` on a
        DTensor (none when it is laid out so already), ``x`` itself on a
        plain tensor or when disabled."""
        if not self.enabled or not _is_dtensor(x):
            return x
        want = placements(x.device_mesh, self.spec(*axes))
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)


NO_SHARD = Shardings(batch=(), model=(), enabled=False)


def serving_mode(*xs):
    """The no-gradient context a serving step on ``xs`` runs in:
    ``torch.inference_mode`` on plain tensors, ``torch.no_grad`` where one
    is a DTensor (inference tensors cannot take DTensor's views)."""
    if any(_is_dtensor(x) for x in xs):
        return torch.no_grad()
    return torch.inference_mode()


def replicated(x):
    """``x`` whole on every rank (a DTensor redistributed to
    ``Replicate()`` on each mesh dim; a plain tensor as it is): the layout
    taken before an op that DTensor has no sharding rule for."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = (Replicate(),) * x.device_mesh.ndim
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def on_replicated(fn, *args):
    """``fn`` run on whole tensors: where an argument is a DTensor, every
    tensor argument is taken whole on each rank (``replicated``), ``fn``
    runs on the local tensors, and each tensor it returns (one, or a
    tuple) comes back as a replicated DTensor.  The layout taken at ops
    that DTensor has no sharding rule for (the MoE's routing, dispatch and
    gather; the SSM scans).  On plain tensors it is ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next((a.device_mesh for a in args if _is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    local = [replicated(a).to_local() if _is_dtensor(a) else a
             for a in args]
    out = fn(*local)
    wrap = lambda t: DTensor.from_local(
        t, mesh, (Replicate(),) * mesh.ndim, run_check=False) \
        if isinstance(t, torch.Tensor) else t
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def compute_dtype(x):
    return x.to(torch.bfloat16)


def _mm(x, w):
    """x @ w for bf16 operands, accumulated in f32 and rounded once, as XLA
    and cuBLAS compute it.  torch's CPU bf16 matmul rounds elsewhere, so
    on the CPU the product is taken in f32 and rounded."""
    if x.is_cuda:
        return x @ w
    return (x.float() @ w.float()).to(torch.promote_types(x.dtype, w.dtype))


def _silu(x):
    """x * sigmoid(x) op by op in x's dtype, as the reference's
    ``jax.nn.silu`` rounds it (``F.silu`` rounds once)."""
    return x * (1 / (1 + torch.exp(-x)))


# ----------------------------------------------------------------- norms
def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x, scale=None, bias=None, eps: float = 1e-5):
    """LayerNorm; scale/bias may be None (OLMo's non-parametric LN)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def apply_norm(x, p, kind: str):
    if kind == "rms":
        return rms_norm(x, p["scale"])
    if kind == "ln":
        return layer_norm(x, p.get("scale"), p.get("bias"))
    if kind == "ln_nonparam":
        return layer_norm(x, None, None)
    raise ValueError(kind)


def init_norm(generator, d, kind: str, device=None):
    if kind == "ln_nonparam":
        return {}
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


# ----------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x (..., S, H, hd); positions (..., S) int32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)          # (hd/2,)
    ang = positions[..., None].float() * freqs       # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : hd // 2].float(), x[..., hd // 2 :].float()
    return torch.cat([xf1 * cos - xf2 * sin,
                      xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# ----------------------------------------------------------------- attention
def _normal(generator, shape, device):
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


def init_attention(generator, cfg, device=None):
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(generator, (d, nh * hd), device) * s,
        "wk": _normal(generator, (d, nkv * hd), device) * s,
        "wv": _normal(generator, (d, nkv * hd), device) * s,
        "wo": _normal(generator, (nh * hd, d), device) * s,
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
    return p


def _qkv(x, p, cfg, positions, sh: Shardings = NO_SHARD):
    B, S, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # heads sharded whole on ``model`` (or not at all) before the split
    q = sh.constrain(_mm(x, compute_dtype(p["wq"])), sh.batch, None,
                     sh.maybe_model(nh)).reshape(B, S, nh, hd)
    k = sh.constrain(_mm(x, compute_dtype(p["wk"])), sh.batch, None,
                     sh.maybe_model(nkv)).reshape(B, S, nkv, hd)
    v = sh.constrain(_mm(x, compute_dtype(p["wv"])), sh.batch, None,
                     sh.maybe_model(nkv)).reshape(B, S, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = sh.constrain(q, sh.batch, None, sh.maybe_model(nh), None)
    k = sh.constrain(k, sh.batch, None, sh.maybe_model(nkv), None)
    v = sh.constrain(v, sh.batch, None, sh.maybe_model(nkv), None)
    return q, k, v


def _head_local(fn, q, k, v):
    """``fn(q, k, v)`` (B, S, heads, hd) -> (B, S, H, hd), an attention
    that mixes no heads, on each rank's heads: on DTensors through
    ``local_map`` (the kernel launches on the local shards), q, k and v
    first laid out alike on every mesh dim (a head dim sharded on q alone
    is gathered: too few KV heads), with S and hd whole.  On plain
    tensors it is ``fn(q, k, v)``."""
    if not _is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    want = tuple(pq if pq == pk == pv and pq in (Shard(0), Shard(2))
                 else Replicate()
                 for pq, pk, pv in zip(q.placements, k.placements,
                                       v.placements))
    q, k, v = (t.redistribute(t.device_mesh, want)
               if tuple(t.placements) != want else t for t in (q, k, v))
    return local_map(fn, out_placements=list(want),
                     in_placements=(list(want),) * 3,
                     device_mesh=q.device_mesh)(q, k, v)


def _sdpa(q, k, v, causal: bool, q_offset=None):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) -> (B,Sq,H,hd).

    GQA via grouped einsum — the KV tensors are never replicated across the
    query-head group."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    qg = q.reshape(B, Sq, KV, rep, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float()
    logits = logits * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (
            0 if q_offset is None else q_offset)
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = logits.masked_fill(~(qi >= ki), NEG)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w, v)
    return out.reshape(B, Sq, H, hd)


ATTN_CHUNK_THRESHOLD = 2048


def attention(x, p, cfg, positions=None, causal=True, *,
              sh: Shardings = NO_SHARD):
    """Full (training / prefill) attention. x (B, S, D)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    q, k, v = _qkv(x, p, cfg, positions, sh)
    if S > ATTN_CHUNK_THRESHOLD and torch.is_grad_enabled() and \
            q.requires_grad:
        # the gradient route: the kernels have no backward, so the layer
        # differentiates the function the reference differentiates, its
        # chunked attention, each query chunk recomputed in the backward
        o = _head_local(lambda q, k, v: _sdpa_chunked(
            q, k, v, causal, 1024, 1024, remat=True), q, k, v)
    elif S > ATTN_CHUNK_THRESHOLD:
        o = _head_local(lambda q, k, v: ops.flash_attention(
            q, k, v, causal=causal, q_chunk=1024, kv_chunk=1024), q, k, v)
    else:
        o = _head_local(lambda q, k, v: _sdpa(q, k, v, causal), q, k, v)
    o = o.reshape(B, S, cfg.n_heads * cfg.head_dim)
    out = _mm(o, compute_dtype(p["wo"]))
    return sh.constrain(out, sh.batch, None, None)


def _quant(x):
    """Per-(token, kv-head) symmetric int8 quantization -> (int8, f32
    scale (..., 1))."""
    s = x.float().abs().amax(-1, keepdim=True) / 127.0 + 1e-12
    return torch.round(x.float() / s).to(torch.int8), s


class LocalSeqShards:
    """The local form of the sequence-sharded decode cache: ``n`` logical
    shards of the one cache's sequence dim on this device, each a view of
    the cache (no copy); a combine is a reduction over the shard dim (dim
    1 of the per-shard stats).  ``decode_attention(seq_shard_axes=n)``
    takes an int for it."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"{n} sequence shards")
        self.n = n

    def max(self, x):
        return x.amax(1, keepdim=True)

    def sum(self, x):
        return x.sum(1, keepdim=True)


class GroupSeqShards:
    """The group form: one shard of the cache's sequence dim per rank
    along the mesh axes ``axes`` (the cache a DTensor sharded so); a
    combine is ``all_reduce`` (MAX, then SUM) on each axis's group."""
    n = 1

    def __init__(self, mesh, axes):
        self.groups = [mesh.get_group(a) for a in axes]
        flat = 0
        for a in axes:
            flat = flat * mesh.size(mesh.mesh_dim_names.index(a)) \
                + mesh.get_local_rank(a)
        self.index = flat

    def _reduce(self, x, op):
        import torch.distributed as dist
        x = x.contiguous()
        for g in self.groups:
            dist.all_reduce(x, op=op, group=g)
        return x

    def max(self, x):
        import torch.distributed as dist
        return self._reduce(x, dist.ReduceOp.MAX)

    def sum(self, x):
        import torch.distributed as dist
        return self._reduce(x, dist.ReduceOp.SUM)


def _flash_decode(q, k_cache, v_cache, pos: int, shards, first: int):
    """The reference's distributed flash-decode on local tensors: q (B, 1,
    H, hd); k_cache, v_cache (B, S_l, KV, hd) hold sequence rows ``first``
    ... ``first + S_l - 1``, cut into ``shards.n`` shards of S_l / n.
    Each shard takes its softmax stats (a max, then ``exp`` against the
    combined max, the weighted sum ``num`` and the weight sum ``den``)
    and ``shards`` combines them.  -> (B, 1, H, hd) in q's dtype."""
    B, S_l, KV, hd = k_cache.shape
    H = q.shape[2]
    n, rep = shards.n, H // KV
    if S_l % n:
        raise ValueError(f"a cache of {S_l} rows does not cut into {n} "
                         f"sequence shards")
    kr = k_cache.view(B, n, S_l // n, KV, hd)
    vr = v_cache.view(B, n, S_l // n, KV, hd)
    qg = q.reshape(B, 1, KV, rep, hd)
    logits = torch.einsum("bqgrd,bnkgd->bngrqk", qg, kr).float()
    logits = logits / math.sqrt(hd)                   # (B,n,KV,rep,1,S_n)
    kidx = first + torch.arange(S_l, device=q.device).view(n, S_l // n)
    logits = logits.masked_fill((kidx > pos)[None, :, None, None, None],
                                NEG)
    m = shards.max(logits.amax(-1, keepdim=True))
    ew = torch.exp(logits - m)
    num = torch.einsum("bngrqk,bnkgd->bnqgrd", ew.to(q.dtype), vr).float()
    den = ew.sum(-1)                                  # (B,n,KV,rep,1)
    num, den = shards.sum(num), shards.sum(den)
    den_q = den[:, 0].permute(0, 3, 1, 2)[..., None]  # (B,1,KV,rep,1)
    o = num[:, 0] / torch.clamp_min(den_q, 1e-30)
    return o.to(q.dtype).reshape(B, 1, H, hd)


def _laid_as(t, mesh, want):
    """``t`` as a DTensor on ``mesh`` laid out as ``want`` (a plain
    tensor counts as replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not _is_dtensor(t):
        t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    return t if tuple(t.placements) == tuple(want) else t.redistribute(
        mesh, tuple(want))


def _seq_sharded(q, k_new, v_new, cache, pos: int, shards):
    """The sequence-sharded decode's cache update and attention core ->
    o (B, 1, H, hd).  ``shards``: a ``LocalSeqShards`` (the local form, on
    the plain cache) or a tuple of mesh axis names (the group form, on a
    cache DTensor sharded over them on dim 1, and maybe over its batch and
    heads).  Each shard writes the new row where ``pos`` falls in its
    rows."""
    if cache["k"].dtype == torch.int8:
        raise ValueError("the sequence-sharded decode takes a bf16 cache, "
                         "not an int8 one")
    if isinstance(shards, LocalSeqShards):
        if _is_dtensor(cache["k"]):
            raise ValueError("the local sequence-sharded form takes the "
                             "plain cache")
        cache["k"][:, pos] = k_new[:, 0]
        cache["v"][:, pos] = v_new[:, 0]
        return _flash_decode(q, cache["k"], cache["v"], pos, shards, 0)
    if not _is_dtensor(cache["k"]):
        raise ValueError(f"seq_shard_axes={shards} (the group form) needs "
                         f"the cache as a DTensor sharded over them; give "
                         f"an int for the local form")
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = cache["k"].device_mesh
    names = mesh.mesh_dim_names
    for a in shards:
        if cache["k"].placements[names.index(a)] != Shard(1):
            raise ValueError(f"the cache is not sequence-sharded over {a!r}: "
                             f"{cache['k'].placements}")
    # q and the new rows as the cache's rank holds it: its batch rows and
    # heads, every position
    heads = tuple(Replicate() if pl == Shard(1) else pl
                  for pl in cache["k"].placements)
    group = GroupSeqShards(mesh, shards)
    kc, vc = cache["k"].to_local(), cache["v"].to_local()
    S_l = kc.shape[1]
    first = group.index * S_l
    ql, kn, vn = (_laid_as(t, mesh, heads).to_local()
                  for t in (q, k_new, v_new))
    if first <= pos < first + S_l:
        kc[:, pos - first] = kn[:, 0]
        vc[:, pos - first] = vn[:, 0]
    o = _flash_decode(ql, kc, vc, pos, group, first)
    o = DTensor.from_local(o, mesh, heads, run_check=False)
    return o if _is_dtensor(q) else o.full_tensor()


def _seq_shards(seq_shard_axes, k_cache):
    """``decode_attention``'s ``seq_shard_axes`` in one of its two forms:
    a ``LocalSeqShards`` (from an int N) for the local form, else a tuple
    of mesh axis names for the group form (when none is given, those a
    DTensor cache's sequence dim is sharded over); () for neither."""
    if isinstance(seq_shard_axes, int):
        return LocalSeqShards(seq_shard_axes)
    if isinstance(seq_shard_axes, LocalSeqShards):
        return seq_shard_axes
    return tuple(seq_shard_axes) or _seq_axes(k_cache)


def _seq_axes(k_cache) -> tuple:
    """The mesh axes a DTensor cache's sequence dim (1) is sharded over
    (``transformer.cache_specs`` gives the model axis to the sequence
    when the KV heads do not divide it); () for a plain cache."""
    if not _is_dtensor(k_cache):
        return ()
    from torch.distributed.tensor import Shard
    names = k_cache.device_mesh.mesh_dim_names
    return tuple(names[i] for i, pl in enumerate(k_cache.placements)
                 if pl == Shard(1))


def _decode_core(q, k_new, v_new, cache, pos: int):
    """The unsharded decode on local tensors: row ``pos`` of the cache
    written in place, then attention over rows 0..pos -> (B, 1, H, hd).
    An int8 cache (with f32 ``k_scale``/``v_scale``) has its
    dequantization folded into the attention einsums — it is never
    materialized in bf16 whole."""
    B, _, H, hd = q.shape
    KV = k_new.shape[2]
    if cache["k"].dtype != torch.int8:
        cache["k"][:, pos] = k_new[:, 0]
        cache["v"][:, pos] = v_new[:, 0]
        return _sdpa(q, cache["k"], cache["v"], causal=True, q_offset=pos)
    rep = H // KV
    k_q, k_s = _quant(k_new)
    v_q, v_s = _quant(v_new)
    cache["k"][:, pos] = k_q[:, 0]
    cache["v"][:, pos] = v_q[:, 0]
    cache["k_scale"][:, pos] = k_s[:, 0]
    cache["v_scale"][:, pos] = v_s[:, 0]
    qg = q.reshape(B, 1, KV, rep, hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg,
                          cache["k"].to(torch.bfloat16)).float()
    # fold in the per-(token, head) scale: (B,S,KV,1)->(B,KV,1,1,S)
    ksT = cache["k_scale"].permute(0, 2, 3, 1)[:, :, :, None, :]
    logits = logits * ksT / math.sqrt(hd)
    kidx = torch.arange(cache["k"].shape[1], device=q.device)
    logits = logits.masked_fill(kidx > pos, NEG)
    w = torch.softmax(logits, dim=-1)
    vsT = cache["v_scale"].permute(0, 2, 3, 1)[:, :, :, None, :]
    o = torch.einsum("bgrqk,bkgd->bqgrd", (w * vsT).to(torch.bfloat16),
                     cache["v"].to(torch.bfloat16))
    return o.reshape(B, 1, H, hd).to(q.dtype)


def _cache_local(fn, q, k_new, v_new, *cache):
    """``fn(q, k_new, v_new, *cache)``, a decode core that writes the
    cache in place, on each rank's shard of a DTensor cache
    (``local_map``): q and the new rows are laid out as the cache is (its
    batch rows and heads; a cache sharded otherwise is refused), so the
    cache's own local tensors are written.  On plain tensors it is
    ``fn`` itself."""
    if not _is_dtensor(cache[0]):
        return fn(q, k_new, v_new, *cache)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = cache[0].device_mesh
    want = tuple(cache[0].placements)
    if any(pl not in (Shard(0), Shard(2), Replicate()) for pl in want):
        raise ValueError(f"a decode cache laid out as {want}: only its "
                         f"batch (0) and heads (2) may be sharded")
    args = [_laid_as(t, mesh, want) for t in (q, k_new, v_new)] + list(cache)
    o = local_map(fn, out_placements=list(want),
                  in_placements=tuple(list(t.placements) for t in args),
                  device_mesh=mesh)(*args)
    return o if _is_dtensor(q) else o.full_tensor()


def decode_attention(x, p, cfg, cache, pos: int, *,
                     seq_shard_axes=(), sh: Shardings = NO_SHARD):
    """One-token decode with KV cache.

    x (B, 1, D); cache dict {k, v: (B, S_max, KV, hd)} (bf16), or int8
    k/v with f32 ``k_scale``/``v_scale`` (B, S_max, KV, 1).  Row ``pos``
    of the cache is written in place (the reference returns an updated
    copy); the returned cache holds the same tensors.

    ``seq_shard_axes``: the cache's sequence dim is sharded, and softmax
    stats are combined across its shards (distributed flash-decode,
    ``_seq_sharded``), enabling long_500k: mesh axis names for the group
    form (one shard per rank), an int N or ``LocalSeqShards`` for the
    local form (N shards on this device).  A DTensor cache sharded on its
    sequence dim takes the group form over those axes unasked, as GSPMD
    inserts the reference's combine.
    """
    B = x.shape[0]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(x, p, cfg, positions, sh)
    H, hd = cfg.n_heads, cfg.head_dim
    shards = _seq_shards(seq_shard_axes, cache["k"])
    if shards:
        o = _seq_sharded(q, k_new, v_new, cache, pos, shards)
    else:
        names = ("k", "v", "k_scale", "v_scale") if \
            cache["k"].dtype == torch.int8 else ("k", "v")
        o = _cache_local(lambda q, kn, vn, *c: _decode_core(
            q, kn, vn, dict(zip(names, c)), pos), q, k_new, v_new,
            *(cache[n] for n in names))
    o = o.reshape(B, 1, H * hd)
    out = _mm(o, compute_dtype(p["wo"]))
    return sh.constrain(out, sh.batch, None, None), cache


# ----------------------------------------------------------------- mlp
def init_mlp(generator, cfg, device=None):
    d, f = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    return {
        "wi": _normal(generator, (d, f), device) * s,
        "wg": _normal(generator, (d, f), device) * s,
        "wo": _normal(generator, (f, d), device) / math.sqrt(f),
    }


def mlp(x, p, *, sh: Shardings = NO_SHARD):
    h = _silu(_mm(x, compute_dtype(p["wg"]))) * _mm(x, compute_dtype(p["wi"]))
    h = sh.constrain(h, sh.batch, None, sh.model)
    return sh.constrain(_mm(h, compute_dtype(p["wo"])), sh.batch, None, None)


# ----------------------------------------------------------------- MoE
def init_moe(generator, cfg, device=None):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = 1.0 / math.sqrt(d)
    return {
        "router": _normal(generator, (d, e), device) * s,
        "wi": _normal(generator, (e, d, f), device) * s,
        "wg": _normal(generator, (e, d, f), device) * s,
        "wo": _normal(generator, (e, f, d), device) / math.sqrt(f),
    }


MOE_SEQ_CHUNK = 4096


def moe(x, p, cfg, capacity_factor: float = 1.25, *,
        sh: Shardings = NO_SHARD):
    """Sequence-chunked wrapper over ``_moe_chunk``: long sequences are
    dispatched in <= MOE_SEQ_CHUNK slices, one after the other, so the
    (B, E*cap, D) dispatch buffer stays bounded.  Capacity is per chunk;
    the aux loss is the chunks' mean.  -> (y, aux)."""
    B, S, D = x.shape
    C = MOE_SEQ_CHUNK
    if S <= C:
        return _moe_chunk(x, p, cfg, capacity_factor, sh=sh)
    if S % C:
        raise ValueError(f"S={S} is not a multiple of MOE_SEQ_CHUNK={C}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(S // C):
        y, a = _moe_chunk(x[:, i * C : (i + 1) * C], p, cfg, capacity_factor,
                          sh=sh)
        aux = aux + a
        ys.append(y)
    return torch.cat(ys, dim=1), aux / (S // C)


def _route(logits, n_experts: int, top_k: int, cap: int):
    """Token-choice top-k routing of f32 router ``logits`` (B, S, E) with
    ``cap`` slots per expert and batch row.  -> (probs, top_p, top_e,
    rank, keep).

    ``top_e`` orders equal probabilities lower expert first, as
    ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk``
    promises no order among ties).  A (token, k) pair's rank within its
    expert counts the pairs before it in (token, k) order: a stable sort
    of the flattened expert ids and, for each, the first position of its
    id (a leftmost ``searchsorted``).  Pairs ranked ``cap`` or later are
    dropped (``keep`` False) and pass through on the residual."""
    B, S, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :top_k], top_e[..., :top_k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    flat_e = top_e.reshape(B, S * top_k)
    sorted_e, order = torch.sort(flat_e, dim=1, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e)          # leftmost equal
    rank_sorted = torch.arange(S * top_k, device=logits.device) - first
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    rank = rank.reshape(B, S, top_k)
    return probs, top_p, top_e, rank, rank < cap


def _dispatch(x, flat_slot, n_rows: int, K: int):
    """Each (token, k) pair of x (B, S, D) to its row ``flat_slot`` (B,
    S*K) of a (B, n_rows, D) buffer of zeros."""
    B, _, D = x.shape
    rows = torch.arange(B, device=x.device)[:, None]
    buf = torch.zeros((B, n_rows, D), dtype=x.dtype, device=x.device)
    buf[rows, flat_slot] = x.repeat_interleave(K, dim=1)
    return buf


def _combine(out, flat_slot, top_p):
    """The experts' rows ``flat_slot`` of out (B, E*cap, D) back to their
    (token, k) pairs (a dropped pair, slot E*cap, reads a zero row),
    summed with the top-k weights -> (B, S, D)."""
    B, _, D = out.shape
    S, K = top_p.shape[1], top_p.shape[2]
    rows = torch.arange(B, device=out.device)[:, None]
    outflat = torch.cat([out, torch.zeros((B, 1, D), dtype=out.dtype,
                                          device=out.device)], dim=1)
    gathered = outflat[rows, flat_slot].reshape(B, S, K, D)
    return (gathered * top_p[..., None].to(out.dtype)).sum(2)


def _moe_chunk(x, p, cfg, capacity_factor: float = 1.25, *,
               sh: Shardings = NO_SHARD):
    """Token-choice top-k MoE with per-batch-row capacity.

    Each (token, k) pair that ``_route`` keeps is scattered to its slot
    ``expert * cap + rank`` of a (B, E*cap + 1, D) buffer; dropped pairs
    all go to the last row, which is cut off before the expert products
    (its duplicate writes land in any order, and nothing reads it).  The
    experts' SwiGLU runs as batched products over (E, cap), the outputs
    are gathered back (a dropped pair reads a zero row) and summed with
    the renormalised top-k weights.  -> (y, Switch-style aux loss).

    On DTensors the routing, the dispatch and the gather run whole on
    each rank (``on_replicated``: DTensor has no rule for the sort, the
    scatter or the indexed gather); the expert products keep the
    weights' expert sharding (EP over ``model``)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    cap = max(int(capacity_factor * S * K / E), 1)
    logits = _mm(x, compute_dtype(p["router"])).float()
    probs, top_p, top_e, rank, keep = on_replicated(
        lambda lg: _route(lg, E, K, cap), logits)
    slot = torch.where(keep, top_e * cap + rank, E * cap)     # (B, S, K)
    flat_slot = slot.reshape(B, S * K)
    buf = on_replicated(lambda a, b: _dispatch(a, b, E * cap + 1, K), x,
                        flat_slot)
    # one (B * cap, D) block an expert: a batched product over E reads
    # each expert's weights once (broadcasting them over B would copy them)
    hidden = buf[:, :-1].reshape(B, E, cap, D).transpose(0, 1).reshape(
        E, B * cap, D)
    hidden = sh.constrain(hidden, sh.model, None, None)
    h = _silu(_mm(hidden, compute_dtype(p["wg"])))
    h = h * _mm(hidden, compute_dtype(p["wi"]))
    out = _mm(h, compute_dtype(p["wo"]))
    out = sh.constrain(out, sh.model, None, None)
    out = out.reshape(E, B, cap, D).transpose(0, 1).reshape(B, E * cap, D)
    combined = on_replicated(_combine, out, flat_slot, top_p)
    # aux load-balancing loss (Switch-style), returned for the trainer
    me = probs.mean((0, 1))
    ce = on_replicated(lambda t: torch.nn.functional.one_hot(
        t[..., 0], E).float(), top_e).mean((0, 1))
    aux = E * (me * ce).sum()
    return sh.constrain(combined, sh.batch, None, None), aux
