"""The port's MoE layer (``repro_torch.models.layers``: ``moe``,
``_moe_chunk``, ``_route``) against the reference's
(``repro/models/layers.py``) on the CPU, with the reference run op by op
(``jax.disable_jit()``), where the two round alike.

Routing (top-k experts, ranks, drops) must be equal on the same router
logits, exact ties included: the port's stable descending sort orders
ties lower expert first, as ``lax.top_k`` does.  Outputs are compared
token by token with the tolerances of ``MOE_ROW_TOL`` below, on seeds
that leave no token undecided (``_undecided``: a token whose top-k gap
lies within the two packages' router-logit difference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl
from test_torch_families import AUX_RTOL, KEY, MOE, _models, _np, _t


def _reference_route(logits, E, K, cap):
    """The routing lines of the reference's ``layers._moe_chunk``."""
    B, S, _ = logits.shape
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, K)
    top_p = top_p / jnp.sum(top_p, axis=-1, keepdims=True)
    flat_e = top_e.reshape(B, S * K)
    order = jnp.argsort(flat_e, axis=1, stable=True)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=1)
    first = jax.vmap(jnp.searchsorted)(sorted_e, sorted_e)
    rank_sorted = (jnp.arange(S * K, dtype=jnp.int32)[None, :]
                   - first.astype(jnp.int32))
    rank = jnp.zeros((B, S * K), jnp.int32)
    rank = rank.at[jnp.arange(B)[:, None], order].set(rank_sorted)
    rank = rank.reshape(B, S, K)
    return probs, top_p, top_e, rank, rank < cap


@pytest.mark.parametrize("E,K,cap", [(8, 2, 5), (64, 6, 3), (4, 1, 20)])
def test_routing_matches_reference(E, K, cap):
    """Top-k experts, their weights, ranks and drops on the same router
    logits: bf16 values (as the router product gives them), with a third
    of the rows holding exact ties across the top-k boundary."""
    rng = np.random.default_rng(E)
    B, S = 2, 96
    lg = np.array(jnp.asarray(rng.standard_normal((B, S, E)),
                              jnp.bfloat16).astype(jnp.float32))
    lg[:, ::3, K] = np.sort(lg[:, ::3], axis=-1)[..., ::-1][..., K - 1]
    want = _reference_route(jnp.asarray(lg), E, K, cap)
    got = tl._route(torch.from_numpy(lg), E, K, cap)
    for name, g, w in zip(("probs", "top_p"), got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    for name, g, w in zip(("top_e", "rank", "keep"), got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert 0 < int((~got[4]).sum()) < B * S * K        # some pairs dropped


def _moe_inputs(cfg, B, S, seed):
    p = jl.init_moe(KEY, cfg)
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)), jnp.bfloat16)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return p, tp, x, _t(x, torch.bfloat16)


def _router_logits(x, p, tx, tp):
    """Both packages' f32 router logits on the same input."""
    want = _np((x @ jl.compute_dtype(p["router"])).astype(jnp.float32))
    got = tl._mm(tx, tl.compute_dtype(tp["router"])).float().numpy()
    return got, want


def _undecided(got, want, K):
    """-> (tokens whose K-th and (K+1)-th reference router logits lie within
    twice the largest difference between the two packages' logits of that
    token: none where the products round alike, for exact ties are broken
    alike; the smallest top-k gap)."""
    srt = np.sort(want, axis=-1)[..., ::-1]
    gap = srt[..., K - 1] - srt[..., K]
    d = np.abs(got - want).max(-1)
    return int(((gap <= 2 * d) & (d > 0)).sum()), float(gap.min())


# an output row against the reference's, as a share of the row's RMS: one
# bf16 step where the token's router logits and its top-k weights rounded
# to bf16 agree (the expert products sum in another order); where either
# differs ("moved": a logit a bf16 step off, or an f32 weight an ulp off
# on the other side of a bf16 rounding boundary), the token's weights
# differ by a bf16 step or more (2^-6 of a logit near 2), and its output
# by that times an expert's output
MOE_ROW_TOL, MOE_MOVED_TOL = 2.0**-8, 2.0**-4


@pytest.mark.parametrize("B,S,cf", [
    (2, 64, 1.25),       # drops: 2*64/8 = 16 slots a chunk of 20 per expert
    (2, 64, 4.0),        # the decode's capacity (E/K): no drops
    # S > MOE_SEQ_CHUNK: two chunks of 4,096 with drops, the aux their mean
    (1, 2 * tl.MOE_SEQ_CHUNK, 1.25),
])
def test_moe_matches_reference(B, S, cf):
    """``layers.moe`` on the same bf16 input and weights against the
    reference op by op.  Seed 3 leaves no token undecided (its smallest
    top-k gap is printed; the S = 8,192 input has exact ties, broken
    alike), so every token's experts, ranks and drops are the
    reference's; outputs within ``MOE_ROW_TOL`` of each row's RMS, and
    ``MOE_MOVED_TOL`` at the moved tokens (printed: none at S = 64, 5 of
    8,192); the aux loss within ``AUX_RTOL``."""
    jc, tc, _, _ = _models(MOE)
    p, tp, x, tx = _moe_inputs(jc, B, S, seed=3)
    lg, want_lg = _router_logits(x, p, tx, tp)
    n_undecided, min_gap = _undecided(lg, want_lg, jc.top_k)
    assert n_undecided == 0
    moved = (lg != want_lg).any(-1)
    C = min(S, tl.MOE_SEQ_CHUNK)
    cap = max(int(cf * C * jc.top_k / jc.n_experts), 1)
    for c in range(0, S, C):
        got_r = tl._route(torch.from_numpy(lg[:, c : c + C]), jc.n_experts,
                          jc.top_k, cap)
        want_r = _reference_route(jnp.asarray(want_lg[:, c : c + C]),
                                  jc.n_experts, jc.top_k, cap)
        for g, w in zip(got_r[2:], want_r[2:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        moved[:, c : c + C] |= (got_r[1].to(torch.bfloat16).float().numpy()
                                != _np(want_r[1].astype(jnp.bfloat16))
                                ).any(-1)
    print(f"smallest top-k router gap {min_gap:.4g}; undecided tokens "
          f"{n_undecided}; moved tokens {int(moved.sum())} of {B * S}")
    with jax.disable_jit():
        want, want_aux = jl.moe(x, p, jc, jl.NO_SHARD, capacity_factor=cf)
    got, aux = tl.moe(tx, tp, tc, capacity_factor=cf)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, jc.d_model)
    g, w = got.float().numpy(), _np(want)
    share = np.abs(g - w).max(-1) / np.sqrt(np.square(w).mean(-1))
    assert (share[~moved] <= MOE_ROW_TOL).all()
    assert (share[moved] <= MOE_MOVED_TOL).all()
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=AUX_RTOL)


def test_moe_drops_fall_back_to_the_residual():
    """A token whose pairs all exceed their experts' capacity gets a zero
    MoE output (the residual carries it), as in the reference."""
    jc, tc, _, _ = _models(MOE)
    p, tp, x, tx = _moe_inputs(jc, 1, 64, seed=3)
    E, K = tc.n_experts, tc.top_k
    cap = max(int(0.1 * 64 * K / E), 1)
    logits = tl._mm(tx, tl.compute_dtype(tp["router"])).float()
    keep = tl._route(logits, E, K, cap)[4]
    dropped = ~keep.any(-1)[0]
    assert dropped.any()
    got, _ = tl.moe(tx, tp, tc, capacity_factor=0.1)
    with jax.disable_jit():
        want, _ = jl.moe(x, p, jc, jl.NO_SHARD, capacity_factor=0.1)
    assert not got[0, dropped].any()
    assert not _np(want)[0, dropped.numpy()].any()


