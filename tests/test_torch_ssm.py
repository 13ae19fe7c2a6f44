"""The port's state-space blocks (``repro_torch.models.ssm``: the chunked
Mamba-1 scan and the Mamba-2 SSD form) against the reference's
(``repro/models/ssm.py``) on the CPU, on ``reduced()`` configs (chunks of
16) with the reference's weights.

Mamba-1's scan reproduces ``jax.lax.associative_scan``'s combine tree, so
its block equals the reference's bit for bit; Mamba-2 agrees within one
bf16 step of each element against the reference op by op.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from test_torch_families import HYBRID, LOGIT_TOL, SSM, _models, _np, _t


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33, 128])
def test_associative_scan_tree_matches_jax(n):
    """The port's scan reproduces ``jax.lax.associative_scan``'s combine
    tree: the same f32 values, bit for bit, at odd and even lengths."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)

    def combine(lft, rgt):
        return lft[0] * rgt[0], rgt[1] + rgt[0] * lft[1]
    wa, wb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ga, gb = tssm._associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    h = rng.standard_normal((2, 3, 4)).astype(np.float32)
    wh, wout = jssm._mamba1_scan_chunk(jnp.asarray(h), jnp.asarray(a),
                                       jnp.asarray(b))
    gh, gout = tssm._mamba1_scan_chunk(torch.from_numpy(h),
                                       torch.from_numpy(a),
                                       torch.from_numpy(b))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    np.testing.assert_array_equal(gout.numpy(), np.asarray(wout))


@pytest.mark.parametrize("arch,block", [
    (SSM, "mamba1_block"), (HYBRID, "mamba2_block")])
def test_ssm_blocks_match_reference(arch, block):
    """One Mamba block on the same bf16 input over four chunks of 16,
    against the reference op by op: Mamba-1 bit for bit (the scan's
    tree is the reference's); Mamba-2 within one bf16 step of each
    element (its SSD products sum in another order: one element of 16,384
    is a step off at this seed)."""
    jc, tc, params, tparams = _models(arch)
    p0 = jax.tree.map(lambda a: a[0], params["blocks"]["mamba"])
    t0 = tt._layer(tparams.tree()["blocks"], 0)["mamba"]
    x = jnp.asarray(np.random.default_rng(4).standard_normal(
        (2, 64, jc.d_model)), jnp.bfloat16)
    assert 64 // jc.ssm_chunk == 4
    with jax.disable_jit(arch == HYBRID):
        want = _np(getattr(jssm, block)(x, p0, jc, jl.NO_SHARD))
    got = getattr(tssm, block)(_t(x, torch.bfloat16), t0, tc).float().numpy()
    if arch == SSM:
        np.testing.assert_array_equal(got, want)
    else:
        step = 2.0**-7 * np.maximum(np.abs(got), np.abs(want))
        assert (np.abs(got - want) <= step).all()


@pytest.mark.parametrize("arch,block", [
    (SSM, "mamba1_block"), (HYBRID, "mamba2_block")])
def test_ssm_chunk_groups_equal_one_group(arch, block, monkeypatch):
    """Chunk groups of one, three and all chunks give the same output: the
    state hand-over between groups is the one between chunks."""
    _, tc, _, tparams = _models(arch)
    t0 = tt._layer(tparams.tree()["blocks"], 0)["mamba"]
    x = _t(np.random.default_rng(5).standard_normal((1, 112, tc.d_model)),
           torch.bfloat16)
    want = getattr(tssm, block)(x, t0, tc)
    per_chunk = (tc.ssm_chunk * tc.ssm_d_inner * tc.ssm_state if arch == SSM
                 else tc.ssm_chunk ** 2 * tc.ssm_heads)
    for g in (1, 3):
        monkeypatch.setattr(tssm, "_SSM_GROUP_ELEMS", g * per_chunk)
        got = getattr(tssm, block)(x, t0, tc)
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.float().numpy())


def test_mamba2_long_chunk_stays_finite():
    """At a chunk of 128 with strong decay (dt about 0.7 a step) the
    reference's unmasked exp(cum_t - cum_s) overflows for s > t and its
    mask multiplies inf by 0: its first rows are NaN (their later keys
    lie furthest ahead in decay).  The port masks before
    the exponential and stays finite, equal within ``LOGIT_TOL`` to the
    reference at a chunk of 16 (the SSD form is exact at any chunk;
    a documented difference, the reference's own fault)."""
    jc, tc, params, tparams = _models(HYBRID, ssm_chunk=128)
    p0 = jax.tree.map(lambda a: a[0], params["blocks"]["mamba"])
    t0 = tt._layer(tparams.tree()["blocks"], 0)["mamba"]
    x = jnp.asarray(np.random.default_rng(6).standard_normal(
        (1, 128, jc.d_model)), jnp.bfloat16)
    broken = _np(jssm.mamba2_block(x, p0, jc, jl.NO_SHARD))
    assert np.isnan(broken[0, 0]).all() and np.isfinite(broken[0, -1]).all()
    want = _np(jssm.mamba2_block(x, p0, dataclasses.replace(
        jc, ssm_chunk=16), jl.NO_SHARD))
    got = tssm.mamba2_block(_t(x, torch.bfloat16), t0, tc).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)




@pytest.mark.parametrize("arch,block", [
    (SSM, "mamba1_block"), (HYBRID, "mamba2_block")])
def test_prefill_past_a_chunk_and_not_a_multiple_is_refused(arch, block):
    """A prefill longer than ``ssm_chunk`` (16) and not a multiple of it
    (S = 37) is refused with ``ValueError`` naming ``ssm_chunk``; the
    reference asserts the same (``repro/models/ssm.py``, an
    ``AssertionError``).  Shorter prefills are one chunk of their own
    length, and multiples of the chunk are taken."""
    _, tc, _, tparams = _models(arch)
    t0 = tt._layer(tparams.tree()["blocks"], 0)["mamba"]
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((1, 37, tc.d_model)), torch.bfloat16)
    assert 37 > tc.ssm_chunk == 16
    with pytest.raises(ValueError, match="ssm_chunk"):
        getattr(tssm, block)(x, t0, tc)
    for S in (15, 32):
        out = getattr(tssm, block)(x[:, :S], t0, tc)
        assert out.shape == (1, S, tc.d_model)
