"""One train step's loss and gradients in the port (``repro_torch.models.lm``
``make_grads_fn`` and ``make_train_step``; ``transformer.forward`` with its
two-level remat; ``layers.attention``'s gradient route) against
``jax.value_and_grad`` of the reference's loss on the CPU, on ``reduced()``
configs of all five families with the reference's weights
(``convert.params_from_jax``) and the same batch.  Both differentiate the
loss against the bf16-cast tree (``transformer.cast_params``).

Tolerances, and why they are that size:
  * the loss: ``LOSS_RTOL``, 5e-4 relative.  The reference runs jitted
    (the MoE op by op, below); XLA fuses the bf16 forward and rounds at
    other places than the port, which moves the loss by up to 1.8e-4 of
    itself (the encoder's layer norms; the dense model 1.4e-5);
  * each gradient leaf: ``GRAD_RTOL``, 0.05 of the leaf's RMS, as the RMS
    of the difference.  The gradients of the cast leaves are bf16 in both
    packages, each element carrying up to 2^-8 of itself; the port's
    products of bf16 operands accumulate in f32 and round once where
    XLA's backward rounds its intermediates to bf16, which compounds to
    1.0-2.6% over four layers (measured: 2.6% at most, the encoder);
  * the MoE aux loss: ``AUX_RTOL``, 1e-4 relative, as
    ``tests/test_torch_families.py`` holds it.  The MoE is held against
    the reference run op by op (``jax.disable_jit()``): jitted, XLA rounds
    a router logit a bf16 step apart and a near-tie token routes to
    another expert (ROADMAP Queue 3);
  * remat on against remat off within the port: bit for bit (the
    recompute runs the same operations on the same values); remat off
    is the path held to the reference.
Each tolerance fails on the planted faults of
``test_planted_faults_fail``: the aux term dropped, the labels shifted by
one, microbatch rows taken contiguously instead of at stride M, one
layer skipped in a remat segment.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.core import attention as tattn
from repro_torch.core.tree import leaves
from repro_torch.kernels import ops as tops
from repro_torch.models import convert, layers as tl, lm as tlm
from repro_torch.models import transformer as tt
from repro_torch.train.optimizer import adamw

KEY = jax.random.key(0)
LOSS_RTOL = 5e-4
GRAD_RTOL = 0.05
AUX_RTOL = 1e-4
DENSE, ENCODER = "smollm-135m", "hubert-xlarge"
MOE, SSM, HYBRID = "moonshot-v1-16b-a3b", "falcon-mamba-7b", "zamba2-2.7b"
ALL = [DENSE, ENCODER, MOE, SSM, HYBRID]
B, S = 2, 32                     # S a multiple of the SSM chunk (16)
REMAT16 = dict(n_layers=16, remat=True)      # the sqrt(L) level runs
LONG_S = 3072                    # past ATTN_CHUNK_THRESHOLD (2048)
# two layers where the reference is slow: the MoE op by op, and S=3,072
SHALLOW = (("n_layers", 2),)
THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these models' tensors are small, and a worker
    of a parallel test run sharing the cores with others runs their steps
    several times faster so (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _configs(arch, **overrides):
    jc = dataclasses.replace(jconfigs.reduced(jconfigs.ARCHS[arch]),
                             **overrides)
    tc = dataclasses.replace(tconfigs.reduced(tconfigs.ARCHS[arch]),
                             **overrides)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _weights(arch, overrides=()):
    """The reference's weights of the reduced config (numpy leaves)."""
    jc, _ = _configs(arch, **dict(overrides))
    return jax.tree.map(np.asarray, jt.init_params(jc, KEY))


def _port_params(arch, overrides=()):
    return tt.as_tree(convert.params_from_jax(_weights(arch, overrides),
                                              device="cpu"))


def _batch(cfg, rows, seq, seed=0):
    """numpy (inputs, labels): tokens, or bf16-exact embeds (float32)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
    if cfg.input_kind == "tokens":
        x = rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
    else:
        x = np.asarray(jnp.asarray(rng.standard_normal(
            (rows, seq, cfg.d_model)) * 0.1, jnp.bfloat16), np.float32)
    return x, labels


def _jbatch(cfg, x, labels):
    key = "tokens" if cfg.input_kind == "tokens" else "embeds"
    v = jnp.asarray(x) if key == "tokens" else jnp.asarray(x, jnp.bfloat16)
    return {key: v, "labels": jnp.asarray(labels)}


def _tbatch(cfg, x, labels):
    key = "tokens" if cfg.input_kind == "tokens" else "embeds"
    v = torch.from_numpy(x) if key == "tokens" else torch.from_numpy(
        x).to(torch.bfloat16)
    return {key: v, "labels": torch.from_numpy(labels)}


@functools.lru_cache(maxsize=None)
def _reference(arch, overrides=(), seq=S, rows=B):
    """jax.value_and_grad of the reference's loss on cast_params -> (loss,
    ce, aux, [gradient leaves]) as numpy; the MoE op by op."""
    jc, _ = _configs(arch, **dict(overrides))
    pc = jt.cast_params(jax.tree.map(jnp.asarray, _weights(arch, overrides)))
    f = jax.value_and_grad(jlm.make_loss_fn(jc), has_aux=True)
    batch = _jbatch(jc, *_batch(jc, rows, seq))
    if jc.family == "moe":
        with jax.disable_jit():
            (loss, m), g = f(pc, batch)
    else:
        (loss, m), g = jax.jit(f)(pc, batch)
    return (float(loss), float(m["ce"]), float(m["moe_aux"]),
            [np.asarray(x, np.float32) for x in jax.tree.leaves(g)])


def _port(arch, overrides=(), seq=S, rows=B):
    _, tc = _configs(arch, **dict(overrides))
    loss, m, g = tlm.make_grads_fn(tc)(_port_params(arch, overrides),
                                       _tbatch(tc, *_batch(tc, rows, seq)))
    return (float(loss), float(m["ce"]), float(m["moe_aux"]),
            [x.numpy() for x in leaves(g)])


def _check(got, want):
    """Raises AssertionError unless the port's (loss, ce, aux, grads) are
    within the module's tolerances of the reference's."""
    for name, g, w in zip(("loss", "ce"), got[:2], want[:2]):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (name, g, w)
    assert abs(got[2] - want[2]) <= AUX_RTOL * abs(want[2]), (got[2],
                                                               want[2])
    assert len(got[3]) == len(want[3])
    for i, (g, w) in enumerate(zip(got[3], want[3])):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert np.isfinite(g).all(), i
        rms = np.sqrt(np.mean(w.astype(np.float64) ** 2))
        err = np.sqrt(np.mean((g.astype(np.float64) - w) ** 2))
        assert err <= GRAD_RTOL * rms, (i, g.shape, err / max(rms, 1e-30))


@pytest.mark.parametrize("arch", ALL)
def test_loss_and_grads_match_reference(arch):
    """Every family's loss, ce, aux and per-leaf gradients (the same
    leaves in ``jax.tree`` order: every leaf of every layer, the embedding
    or not, the norms, the head; the hybrid's shared attention too)."""
    ov = SHALLOW if arch == MOE else ()
    _check(_port(arch, ov), _reference(arch, ov))


def _check_remat_bit_for_bit(arch, overrides):
    """Raises AssertionError unless remat on gives the bits of remat off:
    the loss and every gradient leaf."""
    ov = tuple(overrides.items())
    on = _port(arch, ov)
    off_ov = tuple(dict(overrides, remat=False).items())
    _, tc = _configs(arch, **dict(off_ov))
    off = tlm.make_grads_fn(tc)(_port_params(arch, ov),
                                _tbatch(tc, *_batch(tc, B, S)))
    assert on[0] == float(off[0]), (on[0], float(off[0]))
    for g, w in zip(on[3], leaves(off[2])):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("arch,overrides", [(DENSE, REMAT16),
                                            (HYBRID, dict(remat=True))])
def test_remat_equals_no_remat_bit_for_bit(arch, overrides):
    """Remat recomputes; it changes no bit of the loss or the gradients.
    Dense at 16 layers (both levels: four segments of four); the hybrid's
    runs of attn_every layers (per layer only), with the shared attention
    outside them.  Remat off is held to the reference by
    ``test_loss_and_grads_match_reference``."""
    _check_remat_bit_for_bit(arch, overrides)


def test_long_branch_grads_match_reference():
    """S = 3,072 (past ATTN_CHUNK_THRESHOLD), two layers: the port
    differentiates ``_sdpa_chunked`` (each query chunk recomputed), the
    reference its jnp ``_sdpa_chunked``."""
    _check(_port(DENSE, SHALLOW, seq=LONG_S, rows=1),
           _reference(DENSE, SHALLOW, seq=LONG_S, rows=1))


def _train_metrics(cfg, params, batch, M):
    opt = adamw(warmup=0, total_steps=4)
    state = (params, opt.init(params), torch.zeros((), dtype=torch.int32))
    new, m = tlm.make_train_step(cfg, opt, num_microbatches=M,
                                 device="cpu")(state, batch)
    return new, {k: float(v) for k, v in m.items()}


def test_microbatches_match_one():
    """num_microbatches=4 against 1 on 8 rows, as the reference's
    ``test_microbatch_equivalence`` holds them (its tolerances: the loss
    2e-2 relative, the parameters 5e-2 after one step); the port's
    readings are far inside them."""
    _, tc = _configs(DENSE)
    batch = _tbatch(tc, *_batch(tc, 8, S))
    p = _port_params(DENSE)
    s1, m1 = _train_metrics(tc, p, batch, 1)
    s4, m4 = _train_metrics(tc, p, batch, 4)
    assert m1["loss"] == pytest.approx(m4["loss"], rel=1e-5)
    assert m1["grad_norm"] == pytest.approx(m4["grad_norm"], rel=1e-2)
    worst = max(float((a - b).abs().max())
                for a, b in zip(leaves(s1[0]), leaves(s4[0])))
    assert worst < 5e-2


@functools.lru_cache(maxsize=None)
def _moe_stride_reference(M=2, rows=4):
    """The reference's loss on each stride-M microbatch of ``rows`` rows
    (op by op) -> mean (ce, aux), as its train step averages them."""
    jc, _ = _configs(MOE, **dict(SHALLOW))
    params = jax.tree.map(jnp.asarray, _weights(MOE, SHALLOW))
    x, labels = _batch(jc, rows, S, seed=1)
    f = jlm.make_loss_fn(jc)
    ce, aux = [], []
    with jax.disable_jit():
        for m in range(M):
            _, out = f(jt.cast_params(params),
                       _jbatch(jc, x[m::M], labels[m::M]))
            ce.append(float(out["ce"]))
            aux.append(float(out["moe_aux"]))
    return float(np.mean(ce)), float(np.mean(aux))


def _check_moe_stride():
    _, tc = _configs(MOE, **dict(SHALLOW))
    _, got = _train_metrics(tc, _port_params(MOE, SHALLOW),
                            _tbatch(tc, *_batch(tc, 4, S, seed=1)), 2)
    ce, aux = _moe_stride_reference()
    assert abs(got["ce"] - ce) <= LOSS_RTOL * ce, (got["ce"], ce)
    assert abs(got["moe_aux"] - aux) <= AUX_RTOL * aux, (got["moe_aux"],
                                                         aux)


def test_moe_microbatches_take_rows_at_stride_m():
    """A MoE train step in two microbatches: its ce and aux are the means
    of the reference's on rows 0::2 and 1::2.  The aux loss depends on
    which rows share a microbatch (a product of means over its tokens), so
    it shows the row split."""
    _check_moe_stride()


def _skip_in_segments(monkeypatch):
    saved = tt._seq

    def seq(x, aux, layer_trees, cfg, remat, *rest):
        if remat and len(layer_trees) > 1:
            layer_trees = layer_trees[:-1]
        return saved(x, aux, layer_trees, cfg, remat, *rest)
    monkeypatch.setattr(tt, "_seq", seq)


def _fault_aux(monkeypatch):
    monkeypatch.setattr(tlm, "MOE_AUX_WEIGHT", 0.0)
    _check(_port(MOE, SHALLOW), _reference(MOE, SHALLOW))


def _fault_labels(monkeypatch):
    saved = tlm.cross_entropy
    monkeypatch.setattr(tlm, "cross_entropy", lambda logits, labels: saved(
        logits, labels.roll(1, dims=1)))
    _check(_port(DENSE), _reference(DENSE))


def _fault_contiguous(monkeypatch):
    def contiguous(batch, m, M):
        n = next(iter(batch.values())).shape[0] // M
        return {k: v[m * n:(m + 1) * n] for k, v in batch.items()}
    monkeypatch.setattr(tlm, "microbatch", contiguous)
    _check_moe_stride()


def _fault_remat_skip(monkeypatch):
    _skip_in_segments(monkeypatch)
    _check_remat_bit_for_bit(DENSE, REMAT16)


@pytest.mark.parametrize("fault", [_fault_aux, _fault_labels,
                                   _fault_contiguous, _fault_remat_skip],
                         ids=["aux dropped", "labels shifted",
                              "microbatch rows contiguous",
                              "a layer skipped in a remat segment"])
def test_planted_faults_fail(fault, monkeypatch):
    """Each planted fault fails the check that holds the sound port."""
    with pytest.raises(AssertionError):
        fault(monkeypatch)


def test_flash_refuses_inputs_that_require_grad():
    """``ops.check_no_grad``, the rule ``flash_attention`` applies to CUDA
    inputs before any launch: an input that requires grad is refused while
    gradients are enabled (the kernels have no backward) and taken
    otherwise.  On CPU tensors the wrapper runs its plain version, which
    autograd differentiates."""
    with pytest.raises(tops.KernelLaunchError, match="requires grad"):
        tops.check_no_grad("q", True, True)
    for requires_grad, enabled in ((True, False), (False, True),
                                   (False, False)):
        tops.check_no_grad("q", requires_grad, enabled)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 128, n, 16)).astype(np.float32)).requires_grad_()
        for n in (4, 2, 2))
    out = tops.flash_attention(q, k, v, causal=True, q_chunk=64,
                               kv_chunk=64)
    gq, = torch.autograd.grad(out.square().sum(), [q])
    assert torch.isfinite(gq).all() and gq.abs().max() > 0


def test_attention_names_the_gradient_route(monkeypatch):
    """Past the chunk threshold ``layers.attention`` sends inputs that
    require grad to ``_sdpa_chunked`` (query chunks recomputed) and never
    to ``ops.flash_attention``; without gradients it calls the wrapper."""
    calls = []
    saved = tops.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return saved(*a, **kw)
    monkeypatch.setattr(tops, "flash_attention", counted)
    _, tc = _configs(DENSE)
    p = tt._layer(_port_params(DENSE)["blocks"], 0)["attn"]
    p = {k: v.detach().requires_grad_() for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, LONG_S, tc.d_model)).astype(np.float32)).to(torch.bfloat16)
    out = tl.attention(x, p, tc)
    g = torch.autograd.grad(out.float().square().sum(), [p["wq"]])[0]
    assert not calls and torch.isfinite(g).all()
    with torch.no_grad():
        again = tl.attention(x, p, tc)
    assert calls == [1]
    torch.testing.assert_close(again, out.detach(), rtol=0, atol=0)


def _visit_every_chunk(q, k, v, qc, kc, f32_scores):
    """Causal chunked attention that visits every kv chunk, masked or not:
    the reference's scan."""
    B_, S_, H, hd = q.shape
    KV = k.shape[2]
    kr = k.reshape(B_, S_ // kc, kc, KV, hd)
    vr = v.reshape(B_, S_ // kc, kc, KV, hd)
    qr = q.reshape(B_, S_ // qc, qc, KV, H // KV, hd)
    outs = [_masked_block(qr[:, qi], kr, vr, qi, f32_scores)
            for qi in range(S_ // qc)]
    return torch.cat(outs, dim=1).reshape(B_, S_, H, hd)


def _masked_block(qb, kr, vr, qi, f32_scores):
    """``_q_block`` over every kv chunk, the causal mask applied to all."""
    _, qc, _, _, hd = qb.shape
    kc = kr.shape[2]
    scale = 1.0 / math.sqrt(hd)
    dt = qb.dtype
    if f32_scores:
        qb = qb.float() * scale
    m = torch.full(qb.shape[:1] + (qb.shape[2], qb.shape[3], qc), tattn.NEG)
    l = torch.zeros_like(m)
    acc = torch.zeros(qb.shape, dtype=torch.float32)
    for ki in range(kr.shape[1]):
        kb, vb = kr[:, ki], vr[:, ki]
        if f32_scores:
            s = torch.einsum("bqgrd,bkgd->bgrqk", qb, kb.float())
        else:
            s = torch.einsum("bqgrd,bkgd->bgrqk", qb, kb).float() * scale
        qpos = qi * qc + torch.arange(qc)[:, None]
        kpos = ki * kc + torch.arange(kc)[None, :]
        s = s.masked_fill(~(qpos >= kpos), tattn.NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        p = p.to(vb.dtype)
        if f32_scores:
            pv = torch.einsum("bgrqk,bkgd->bqgrd", p.float(), vb.float())
        else:
            pv = torch.einsum("bgrqk,bkgd->bqgrd", p, vb).float()
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    out = acc / l.permute(0, 3, 1, 2).clamp_min(1e-30)[..., None]
    return out.to(dt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qc,kc", [(64, 64), (64, 32), (32, 64)])
@pytest.mark.parametrize("f32_scores", [False, True])
def test_sdpa_chunked_skips_masked_chunks_exactly(dtype, qc, kc,
                                                  f32_scores):
    """Causal, ``_sdpa_chunked`` skips the kv chunks past a query chunk's
    last row; its output equals, bit for bit, a loop that visits and masks
    every chunk, as the reference's scan does."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, 256, n, 16)).astype(np.float32)).to(dtype) for n in (4, 2, 2))
    got = tattn._sdpa_chunked(q, k, v, True, qc, kc, f32_scores=f32_scores)
    want = _visit_every_chunk(q, k, v, qc, kc, f32_scores)
    assert torch.equal(got, want)
