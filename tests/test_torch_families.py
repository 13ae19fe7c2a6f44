"""The moe, ssm and hybrid families of the port's LM (the families'
branches of ``repro_torch.models.transformer`` and ``lm``) against the
reference's on the CPU, on ``reduced()`` configs with the reference's
weights handed over by ``convert.params_from_jax``.  Their layers are
held in ``tests/test_torch_moe.py`` and ``tests/test_torch_ssm.py``.

Tolerances and what they cover:
  * the reference runs jitted, as ``tests/test_torch_lm.py`` runs it,
    except the MoE's prefill and generation, which run op by op
    (``jax.disable_jit()``), where the port rounds as the reference does
    (Moonlight's logits within one bf16 step: the f32 mean of an RMS norm
    sums in another order).  Under ``jit`` and ``scan`` XLA rounds bf16
    elsewhere, which moves a router logit by a step and sends a token
    whose top-k gap is that step to another expert (Moonlight at seed 0:
    aux 5.0392 jitted against 5.0233 op by op; the port 5.0234), and
    generation takes another token from there;
  * logits: ``LOGIT_TOL`` (0.1 absolute) and the argmax where the top two
    reference logits are more than two tolerances apart, as
    ``tests/test_torch_lm.py`` holds the dense families;
  * the MoE aux loss: ``AUX_RTOL``, 1e-4 relative (f32 means of the
    router probabilities over the tokens, inputs a bf16 step apart);
  * decode against forward within the port: 1e-3 for the MoE (its forward
    given the decode's capacity, E/K, so that neither drops a token: the
    reference's smoke test leaves the MoE out for that reason) and 0.05
    for the SSM families, the reference's own tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as tops
from repro_torch.models import convert, layers as tl, lm as tlm
from repro_torch.models import transformer as tt

KEY = jax.random.key(0)
LOGIT_TOL = 0.1
AUX_RTOL = 1e-4
MOE, SSM, HYBRID = "moonshot-v1-16b-a3b", "falcon-mamba-7b", "zamba2-2.7b"
FAMILIES = [MOE, SSM, HYBRID]


def _np(a):
    return np.asarray(a, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _models(arch, **overrides):
    jc = dataclasses.replace(jconfigs.reduced(jconfigs.ARCHS[arch]),
                             **overrides)
    tc = dataclasses.replace(tconfigs.reduced(tconfigs.ARCHS[arch]),
                             **overrides)
    params = jt.init_params(jc, KEY)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                      device="cpu")
    return jc, tc, params, tparams


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _check_logits(got, want):
    """-> rows whose argmax was compared (top two reference logits more
    than two tolerances apart)."""
    g, w = got.float().numpy(), _np(want)
    np.testing.assert_allclose(g, w, atol=LOGIT_TOL, rtol=0)
    top2 = np.sort(w, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2 * LOGIT_TOL
    np.testing.assert_array_equal(g.argmax(-1)[decided],
                                  w.argmax(-1)[decided])
    return int(decided.sum())


def _flat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture
def full_capacity(monkeypatch):
    """The MoE's prefill capacity raised to the decode's (E/K): no drops."""
    moe = tl.moe
    monkeypatch.setattr(tl, "moe", lambda x, p, cfg, capacity_factor=1.25:
                        moe(x, p, cfg, cfg.n_experts / cfg.top_k))


# ------------------------------------------------------------- the models
def test_init_params_draws_cast_leaves_in_bf16():
    """``cast=True`` stores the leaves ``cast_params`` would cast in bf16,
    the values it would give; the ``_KEEP_F32`` leaves stay float32."""
    for arch in FAMILIES:
        tc = tconfigs.reduced(tconfigs.ARCHS[arch])
        f32 = tt.init_params(tc, torch.Generator().manual_seed(1))
        bf = tt.init_params(tc, torch.Generator().manual_seed(1),
                            cast=True).state_dict()
        want = {k: v for k, v in
                _flat_state(tt.cast_params(f32)).items()}
        assert sorted(bf) == sorted(want)
        for name, leaf in want.items():
            assert bf[name].dtype == leaf.dtype, name
            assert torch.equal(bf[name], leaf), name
        assert bf["blocks.ln1.scale"].dtype == torch.float32
        assert any(v.dtype == torch.bfloat16 for v in bf.values())


def _flat_state(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_state(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_jax_carries_the_family_trees(arch):
    """Name for name (``blocks.moe.router``, ``blocks.mamba.A_log``,
    ``shared_attn.attn.wq``, ...), values equal, and the port's own init
    draws the same tree, shapes and dtypes."""
    jc, tc, params, tparams = _models(arch)
    flat = _flat(params)
    state = tparams.state_dict()
    assert sorted(state) == sorted(flat)
    for name, leaf in flat.items():
        np.testing.assert_array_equal(state[name].numpy(), np.asarray(leaf))
    own = tt.init_params(tc, torch.Generator().manual_seed(0)).state_dict()
    assert sorted(own) == sorted(flat)
    for name, leaf in flat.items():
        assert tuple(own[name].shape) == leaf.shape, name
        assert own[name].dtype == torch.float32, name
    key = {MOE: "blocks.moe.router", SSM: "blocks.mamba.A_log",
           HYBRID: "shared_attn.attn.wq"}[arch]
    assert key in state


@pytest.mark.parametrize("arch,S,seed", [
    (MOE, 32, 0), (SSM, 32, 0), (HYBRID, 32, 0),
    # more than one ssm_chunk (16) and, hybrid, two shared-attention sites
    (SSM, 48, 1), (HYBRID, 48, 1),
])
def test_forward_last_only_matches_reference(arch, S, seed):
    """Prefill logits (``last_only``) and the MoE aux against the
    reference op by op; the MoE seed routes every token as the reference
    does (its smallest top-k gap is several bf16 steps)."""
    jc, tc, params, tparams = _models(arch)
    toks = _tokens(jc, 2, S, seed)
    with jax.disable_jit(arch == MOE):
        want, want_aux = jt.forward(params, {"tokens": jnp.asarray(toks)},
                                    jc, last_only=True)
    got, aux = tt.forward(tparams, {"tokens": torch.from_numpy(toks)}, tc,
                          last_only=True)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1, jc.vocab_size)
    _check_logits(got, want)
    if arch == MOE:
        assert float(aux) > 0
        np.testing.assert_allclose(float(aux), float(want_aux),
                                   rtol=AUX_RTOL)
    else:
        assert float(aux) == float(want_aux) == 0.0


def test_moe_prefill_chunked_path_matches_reference():
    """A Moonlight-reduced prefill at S = 2 x MOE_SEQ_CHUNK: the MoE runs
    two chunks of 4,096 a layer (with drops) and attention the long
    (flash) branch, on its plain version here."""
    jc, tc, params, tparams = _models(MOE, n_layers=1)
    S = 2 * tl.MOE_SEQ_CHUNK
    toks = _tokens(jc, 1, S, 2)
    want = jlm.make_prefill_step(jc)(params, {"tokens": jnp.asarray(toks)})
    tops.reset_launch_counts()
    got = tlm.make_prefill_step(tc, device="cpu")(
        tparams, {"tokens": torch.from_numpy(toks)})
    assert tops.LAUNCHES["flash_attention"] == 0
    assert got.shape == (1, jc.vocab_size)
    _check_logits(got, want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_step_matches_reference(arch):
    """``make_serve_step`` against the reference's, token by token, and the
    decode state it leaves (the SSM state, the hybrid's site caches)."""
    jc, tc, params, tparams = _models(arch)
    B, T = 2, 6
    toks = _tokens(jc, B, T, 3)
    jserve = jax.jit(jlm.make_serve_step(jc))
    tserve = tlm.make_serve_step(tc, device="cpu")
    jcache = jt.init_cache(jc, B, 8)
    tcache = tt.init_cache(tc, B, 8, device="cpu")
    assert sorted(_flat(jcache)) == sorted(_flat_state(tcache))
    for name, leaf in _flat(jcache).items():
        assert tuple(_flat_state(tcache)[name].shape) == leaf.shape, name
    for t in range(T):
        jlg, jcache = jserve(params, jcache, jnp.asarray(toks[:, t : t + 1]),
                             jnp.int32(t))
        tlg, tcache = tserve(tparams, tcache,
                             torch.from_numpy(toks[:, t : t + 1]), t)
        _check_logits(tlg, jlg)
    got = _flat_state(tcache)
    for name, leaf in _flat(jcache).items():
        np.testing.assert_allclose(got[name].float().numpy(), _np(leaf),
                                   atol=LOGIT_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("arch,tol", [(MOE, 1e-3), (SSM, 0.05),
                                      (HYBRID, 0.05)])
def test_decode_matches_forward(arch, tol, full_capacity):
    """Step-by-step decode reproduces the full forward's last logits."""
    _, tc, _, tparams = _models(arch)
    B, T = 2, 6
    toks = torch.from_numpy(_tokens(tc, B, T, 7))
    full, _ = tt.forward(tparams, {"tokens": toks}, tc)
    serve = tlm.make_serve_step(tc, device="cpu")
    cache = tt.init_cache(tc, B, 8, device="cpu")
    for t in range(T):
        lg, cache = serve(tparams, cache, toks[:, t : t + 1], t)
    np.testing.assert_allclose(full[:, -1].float().numpy(),
                               lg.float().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_generate_matches_reference(arch):
    jc, tc, params, tparams = _models(arch)
    prompt = _tokens(jc, 2, 4, 9)
    with jax.disable_jit(arch == MOE):
        want = jlm.greedy_generate(params, jc, jnp.asarray(prompt), n_new=6)
    got = tlm.greedy_generate(tparams, tc, torch.from_numpy(prompt), 6,
                              device="cpu")
    assert got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
