"""The port's LM serving path (``repro_torch.models``, ``repro_torch.configs``
and ``ops.flash_attention``) against the reference's on the CPU, where the
flash-attention wrapper runs its plain version.

Inputs come from numpy seeds; weights are the reference's
``init_params`` handed to the port through ``convert.params_from_jax``.
Tolerances:
  * f32 attention: 2e-3, the reference kernel test's own;
  * bf16 logits: 0.1 absolute at |logit| up to ~4 (about six bf16 ulps
    there).  Eager JAX and the port agree bit for bit on one block; under
    jit and scan XLA fuses elementwise chains and rounds to bf16 at other
    places, which moves logits by a few ulps after four layers.  The
    argmax must agree on every row whose top two reference logits are
    more than two tolerances apart: a random 512-word model's bf16 logits
    often tie exactly, and a tie is broken by those few ulps;
  * decode against forward within the port: 1e-3, as the reference's
    ``tests/test_models_smoke.py`` holds it.
  * bf16 attention, the wrapper on CPU tensors against the Pallas kernel:
    2^-6 |ref| + 2^-5 x the RMS of the row (its hd outputs).  The
    wrapper's plain version rounds Q.K^T and P.V to bf16 (the reference
    model's einsums), the Pallas body keeps f32 scores, so a score moves
    by up to 2^-8 of itself and p by about as much times the score; each
    side also rounds its output to bf16 once.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import dartpim as jdartpim
from repro.kernels import ops as jops
from repro.models import layers as jl
from repro.models import lm as jlm
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.configs import dartpim as tdartpim
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import ops as tops
from repro_torch.models import convert, layers as tl, lm as tlm
from repro_torch.models import transformer as tt

KEY = jax.random.key(0)
F32_TOL = 2e-3
LOGIT_TOL = 0.1
LM_ARCHS = ["smollm-135m", "olmo-1b", "qwen3-0.6b", "stablelm-3b",
            "hubert-xlarge"]


def _np(a):
    return np.asarray(a, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _models(arch, **overrides):
    """Reduced configs of both packages, with ``overrides`` on top, and the
    same weights in each."""
    jc = dataclasses.replace(jconfigs.reduced(jconfigs.ARCHS[arch]),
                             **overrides)
    tc = dataclasses.replace(tconfigs.reduced(tconfigs.ARCHS[arch]),
                             **overrides)
    params = jt.init_params(jc, KEY)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                      device="cpu")
    return jc, tc, params, tparams


def _batch(cfg, B, S, seed=0):
    """The same prefill batch for both packages (bf16 embeds made in JAX
    and handed over exactly)."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "tokens":
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(
            toks)}
    e = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)) * 0.1,
                    jnp.bfloat16)
    return {"embeds": e}, {"embeds": _t(e, torch.bfloat16)}


def _check_logits(got, want):
    """-> rows whose argmax was compared (see the module docstring)."""
    g, w = got.float().numpy(), _np(want)
    np.testing.assert_allclose(g, w, atol=LOGIT_TOL, rtol=0)
    top2 = np.sort(w, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2 * LOGIT_TOL
    np.testing.assert_array_equal(g.argmax(-1)[decided],
                                  w.argmax(-1)[decided])
    return int(decided.sum())


def _attn_inputs(rng, B, S, H, KV, hd):
    return [rng.standard_normal((B, S, n, hd)).astype(np.float32)
            for n in (H, KV, KV)]


# ------------------------------------------------------------- configs
def test_configs_equal_reference():
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)
    for arch, jc in jconfigs.ARCHS.items():
        tc = tconfigs.get_config(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert dataclasses.asdict(tconfigs.reduced(tc)) == \
            dataclasses.asdict(jconfigs.reduced(jc))
        assert (tc.n_params(), tc.active_params()) == (
            jc.n_params(), jc.active_params())
        for name, shape in jconfigs.SHAPES.items():
            assert dataclasses.asdict(tconfigs.SHAPES[name]) == \
                dataclasses.asdict(shape)
            assert tconfigs.cell_applicable(tc, tconfigs.SHAPES[name]) == \
                jconfigs.cell_applicable(jc, shape)
    for f in ("read_len", "k", "w", "eth", "sat_affine", "max_minis",
              "max_pls", "filter_threshold"):        # Table III
        assert getattr(tdartpim.MAPPER, f) == getattr(jdartpim.MAPPER, f)
    for name in ("MAX_READS", "LOW_TH", "READS_FIFO_ROWS",
                 "LINEAR_BUF_ROWS", "AFFINE_BUF_ROWS"):
        assert getattr(tdartpim, name) == getattr(jdartpim, name)
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


# --------------------------------------------------- the flash kernel
def _case(*case, dtype=torch.float32):
    """A flash case with the id of its numbers (and "-bf16" for bf16)."""
    name = "-".join(map(str, case))
    return pytest.param(*case, dtype,
                        id=name + ("-bf16" if dtype == torch.bfloat16
                                   else ""))


@pytest.mark.parametrize("B,S,H,KV,hd,causal,qc,kc,dtype", [
    _case(2, 128, 4, 2, 32, True, 64, 64),
    _case(1, 256, 8, 8, 16, True, 64, 128),
    _case(2, 128, 6, 2, 32, False, 32, 64),
    _case(1, 64, 4, 1, 64, True, 64, 32),
    # StableLM-3B's head dim, on the tensor-core kernel in bf16
    _case(1, 256, 4, 4, 80, True, 128, 128),
    _case(1, 256, 4, 4, 80, False, 128, 128),
    # bf16 at head dims 16 and 32, on the tensor-core kernel on the card
    _case(2, 128, 4, 2, 32, True, 64, 64, dtype=torch.bfloat16),
    _case(1, 256, 8, 8, 16, True, 64, 128, dtype=torch.bfloat16),
    _case(2, 128, 6, 2, 32, False, 32, 64, dtype=torch.bfloat16),
    _case(1, 256, 4, 2, 16, False, 128, 128, dtype=torch.bfloat16),
])
def test_flash_attention_matches_pallas(B, S, H, KV, hd, causal, qc, kc,
                                        dtype):
    """The wrapper on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode, on the reference kernel test's shapes, in
    float32 (2e-3) and in bf16 (see the module docstring)."""
    q, k, v = _attn_inputs(np.random.default_rng(5), B, S, H, KV, hd)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = _np(jops.flash_attention(
        *(jnp.asarray(a, jdtype) for a in (q, k, v)), causal=causal,
        q_chunk=qc, kv_chunk=kc).astype(jnp.float32))
    tops.reset_launch_counts()
    got = tops.flash_attention(*(_t(a, dtype) for a in (q, k, v)),
                               causal=causal, q_chunk=qc, kv_chunk=kc)
    assert got.dtype == dtype and got.shape == (B, S, H, hd)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL,
                                   rtol=F32_TOL)
    else:
        rms = np.sqrt(np.square(want).mean(-1, keepdims=True))
        tol = 2.0**-6 * np.abs(want) + 2.0**-5 * rms
        assert (np.abs(got.float().numpy() - want) <= tol).all()
    assert tops.LAUNCHES["flash_attention"] == 0
    assert tops.LAUNCHES["flash_attention_wgmma"] == 0


@pytest.mark.parametrize("B,S,H,KV,hd,causal,qc,kc", [
    (2, 128, 4, 2, 32, True, 64, 64),
    (1, 256, 8, 8, 16, True, 64, 128),
    (2, 128, 6, 2, 32, False, 32, 64),
    (1, 64, 4, 1, 64, True, 64, 32),
    # the tensor-core kernel's 128-row query and key tiles
    (1, 256, 8, 2, 128, True, 128, 128),
    (1, 384, 9, 3, 64, True, 128, 128),
    (2, 256, 4, 4, 64, False, 128, 128),
    (1, 256, 4, 4, 80, True, 128, 128),
    (1, 256, 4, 2, 80, False, 128, 128),
])
def test_kernel_arithmetic_matches_pallas_bf16(B, S, H, KV, hd, causal, qc,
                                               kc):
    """``_sdpa_chunked(f32_scores=True)``, the plain version the Hopper
    kernels are held against on the card, against the Pallas kernel in
    interpret mode on bf16 inputs; with chunks of 128 it sums over the
    tensor-core kernel's tiles.  Tolerance per element: 2^-7 |ref| (each
    side rounds its output to bf16 once) plus 2^-6 of the row's RMS (the
    row's hd outputs), which chip_smoke.py applies on the card."""
    q, k, v = _attn_inputs(np.random.default_rng(5), B, S, H, KV, hd)
    want = _np(jops.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal,
        q_chunk=qc, kv_chunk=kc).astype(jnp.float32))
    got = tl._sdpa_chunked(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                           causal, qc, kc, f32_scores=True)
    assert got.dtype == torch.bfloat16
    rms = np.sqrt(np.square(want).mean(-1, keepdims=True))
    tol = 2.0**-7 * np.abs(want) + 2.0**-6 * rms
    assert (np.abs(got.float().numpy() - want) <= tol).all()


@pytest.mark.parametrize("dtype,hd,kernel", [
    (torch.bfloat16, 64, "flash_attention_wgmma"),
    (torch.bfloat16, 128, "flash_attention_wgmma"),
    (torch.bfloat16, 16, "flash_attention_wgmma"),
    (torch.bfloat16, 32, "flash_attention_wgmma"),
    (torch.bfloat16, 80, "flash_attention_wgmma"),
    (torch.float32, 64, "flash_attention"),
    (torch.float32, 80, "flash_attention"),
    (torch.float32, 128, "flash_attention"),
    (torch.float32, 16, "flash_attention"),
    (torch.float32, 32, "flash_attention"),
])
def test_flash_kernel_route(dtype, hd, kernel):
    """bf16 goes to the tensor-core kernel and float32 to the CUDA-core
    kernel at every head dim, and both have a C entry in
    build.ENTRIES."""
    assert tops.flash_kernel(dtype, hd) == kernel
    assert f"{kernel}_launch" in tbuild.ENTRIES


@pytest.mark.parametrize("dtype,hd,exc", [
    (torch.bfloat16, 96, ValueError),
    (torch.float32, 256, ValueError),
    (torch.float16, 64, TypeError),
])
def test_flash_kernel_route_refuses(dtype, hd, exc):
    with pytest.raises(exc):
        tops.flash_kernel(dtype, hd)


def _chip_smoke():
    """chip_smoke.py as a module (it imports nothing of torch until it
    runs)."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_checks_every_flash_route():
    """Every (dtype, head dim) that ``flash_kernel`` sends to a kernel is
    held to its plain version by one of chip_smoke.py's checked sweeps
    (float32: FLASH_SWEEP; bf16: FLASH_BF16_SWEEP, whose cases also meet
    the planted faults), and its edge shapes cover every head dim; the
    faults' kv tile is each kernel's."""
    cs = _chip_smoke()
    checked = {(torch.float32, c[4]) for c in cs.FLASH_SWEEP}
    checked |= {(torch.bfloat16, c[4]) for c in cs.FLASH_BF16_SWEEP}
    routed = set()
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for hd in range(1, 257):
            try:
                kernel = tops.flash_kernel(dtype, hd)
            except (TypeError, ValueError):
                continue
            routed.add((dtype, hd))
            assert kernel in cs.FLASH_TILE
            assert cs._route(dtype, hd) == kernel
    assert routed and routed <= checked, routed - checked
    assert {hd for _, hd in routed} == set(cs.FLASH_EDGE_HEAD_DIMS)


def _bf16_view(offset, strides, shape=(2, 8, 4, 64)):
    """A (B, S, heads, hd) bf16 view of a CPU buffer, ``offset`` elements
    in, with element ``strides``: the description the TMA check reads."""
    buf = torch.zeros(8192 + offset, dtype=torch.bfloat16)
    return buf.as_strided(shape, strides, offset)


@pytest.mark.parametrize("case,offset,strides,ok", [
    ("contiguous", 0, (2048, 256, 64, 1), True),
    ("a fused projection's slice", 64, (3072, 384, 64, 1), True),
    ("base 2 bytes past alignment", 1, (2048, 256, 64, 1), False),
    ("base 8 bytes past alignment", 4, (2048, 256, 64, 1), False),
    ("head stride of 65 elements", 0, (2200, 264, 65, 1), False),
    ("seq stride of 260 elements", 0, (2100, 260, 64, 1), False),
    ("batch stride of 2049 elements", 0, (2049, 256, 64, 1), False),
    # head dim 80: a 160-byte head is ten 16-byte units
    ("hd 80, contiguous", 0, (2560, 320, 80, 1), True),
    ("hd 80, base 8 elements in (16 bytes)", 8, (2560, 320, 80, 1), True),
    ("hd 80, base 4 elements in (8 bytes)", 4, (2560, 320, 80, 1), False),
    ("hd 80, head stride of 84 elements", 0, (2688, 336, 84, 1), False),
])
def test_check_tma(case, offset, strides, ok):
    """The tensor-core kernel's TMA rules on CPU-side descriptions: a base
    and (batch, seq, head) strides of multiples of 16 bytes pass, any other
    raises (the wrapper never falls back to the CUDA-core body)."""
    hd = 80 if case.startswith("hd 80") else 64
    t = _bf16_view(offset, strides, shape=(2, 8, 4, hd))
    args = ("q", t.data_ptr(), t.stride()[:3], t.element_size())
    if ok:
        tops.check_tma(*args)
    else:
        with pytest.raises(ValueError, match="TMA"):
            tops.check_tma(*args)


def test_check_tma_batch_stride_past_2_31():
    """chip_smoke.py's 64-bit case: q's batch stride of 2^31 elements
    (4 GiB) meets the rules."""
    tops.check_tma("q", 0, (2**31, 256, 64), 2)


def _qkv_t(B=1, S=64, H=4, KV=2, hd=32, dtype=torch.float32):
    return [torch.zeros((B, S, n, hd), dtype=dtype) for n in (H, KV, KV)]


@pytest.mark.parametrize("case,exc", [
    ("int dtype", TypeError),
    ("float16", TypeError),
    ("mixed dtypes", TypeError),
    ("3-D q", ValueError),
    ("heads not a multiple", ValueError),
    ("k shape", ValueError),
    ("q_chunk does not divide S", ValueError),
    ("kv_chunk does not divide S", ValueError),
])
def test_flash_attention_wrapper_errors(case, exc):
    q, k, v = _qkv_t()
    kw = {}
    if case == "int dtype":
        q, k, v = (t.to(torch.int32) for t in (q, k, v))
    elif case == "float16":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "mixed dtypes":
        v = v.to(torch.bfloat16)
    elif case == "3-D q":
        q = q[0]
    elif case == "heads not a multiple":
        q, k, v = _qkv_t(H=6, KV=4)
    elif case == "k shape":
        k = torch.zeros((1, 32, 2, 32))
    elif case == "q_chunk does not divide S":
        kw = dict(q_chunk=48)
    else:
        kw = dict(kv_chunk=24)
    with pytest.raises(exc):
        tops.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_and_chunked_match_reference(causal):
    """The shapes of the reference's chunked-attention test
    (tests/test_serving.py)."""
    q, k, v = _attn_inputs(np.random.default_rng(0), 2, 256, 4, 2, 16)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (_t(a) for a in (q, k, v))
    np.testing.assert_allclose(
        tl._sdpa(tq, tk, tv, causal).numpy(),
        _np(jl._sdpa(jq, jk, jv, causal=causal)), atol=F32_TOL, rtol=F32_TOL)
    want = _np(jl._sdpa_chunked(jq, jk, jv, causal=causal, q_chunk=64,
                                kv_chunk=64))
    for f32_scores in (False, True):     # the same function in float32
        np.testing.assert_allclose(
            tl._sdpa_chunked(tq, tk, tv, causal, q_chunk=64, kv_chunk=64,
                             f32_scores=f32_scores).numpy(),
            want, atol=F32_TOL, rtol=F32_TOL)


# ------------------------------------------------------------ building blocks
def test_norms_rope_qkv_mlp_match_reference():
    jc, tc, params, tparams = _models("qwen3-0.6b")   # qk-norm and RoPE
    p0 = jax.tree.map(lambda a: a[0], params["blocks"])
    t0 = tt._layer(tparams.tree()["blocks"], 0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, jc.d_model)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(jc.d_model)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(jc.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), _t(x)

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_TOL,
                                   rtol=F32_TOL)

    close(tl.rms_norm(tx, _t(scale)), jl.rms_norm(jx, jnp.asarray(scale)))
    close(tl.layer_norm(tx, _t(scale), _t(bias)),
          jl.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias)))
    for kind in ("rms", "ln", "ln_nonparam"):
        close(tl.apply_norm(tx, {"scale": _t(scale)}, kind),
              jl.apply_norm(jx, {"scale": jnp.asarray(scale)}, kind))
    pos = np.arange(16, dtype=np.int32)[None].repeat(2, 0) + 5
    xh = x.reshape(2, 16, 4, 32)
    close(tl.apply_rope(_t(xh), torch.from_numpy(pos), 1e6),
          jl.apply_rope(jnp.asarray(xh), jnp.asarray(pos), 1e6))
    close(tl.rope_freqs(32, 1e6), jl.rope_freqs(32, 1e6))
    for got, want in zip(tl._qkv(tx, t0["attn"], tc, torch.from_numpy(pos)),
                         jl._qkv(jx, p0["attn"], jc, jnp.asarray(pos),
                                 jl.NO_SHARD)):
        close(got, want)
    close(tl.attention(tx, t0["attn"], tc),
          jl.attention(jx, p0["attn"], jc, jl.NO_SHARD))
    close(tl.mlp(tx, t0["mlp"]), jl.mlp(jx, p0["mlp"], jl.NO_SHARD))


def test_one_block_bf16_bit_identical_to_eager_reference():
    """Op for op in bf16, the port rounds where eager JAX does."""
    jc, tc, params, tparams = _models("smollm-135m")
    jp = jax.tree.map(lambda a: a[0], jt.cast_params(params)["blocks"])
    tp = tt._layer(tt.cast_params(tparams)["blocks"], 0)
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (2, 32, jc.d_model)), jnp.bfloat16)
    want = jt._block_fwd(x, jp, jc, jl.NO_SHARD)[0]
    got = tt._block_fwd(_t(x, torch.bfloat16), tp, tc)[0]
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


# ------------------------------------------------------------- the model
def test_params_from_jax_names_and_shapes():
    jc, tc, params, tparams = _models("qwen3-0.6b")
    flat = {".".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    state = tparams.state_dict()
    assert sorted(state) == sorted(flat)
    for name, leaf in flat.items():
        np.testing.assert_array_equal(state[name].numpy(), np.asarray(leaf))
    assert tuple(state["blocks.attn.wq"].shape) == (
        jc.n_layers, jc.d_model, jc.n_heads * jc.head_dim)
    assert not any(p.requires_grad for p in tparams.parameters())


@pytest.mark.parametrize("arch", ["smollm-135m", "olmo-1b", "hubert-xlarge"])
def test_init_params_shapes_and_scales(arch):
    """Same tree, shapes and dtypes as the reference's init; the numbers
    come from a torch.Generator, at the reference's scales."""
    jc = jconfigs.reduced(jconfigs.ARCHS[arch])
    tc = tconfigs.reduced(tconfigs.ARCHS[arch])
    want = jax.eval_shape(lambda k: jt.init_params(jc, k), KEY)
    flat = {".".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = tt.init_params(tc, torch.Generator().manual_seed(0)).state_dict()
    assert sorted(got) == sorted(flat)
    for name, leaf in flat.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert got[name].dtype == torch.float32
    d = tc.d_model
    assert abs(float(got["blocks.attn.wq"].std()) * d ** 0.5 - 1) < 0.05
    assert abs(float(got["lm_head"].std()) * d ** 0.5 - 1) < 0.05
    again = tt.init_params(tc, torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(got[n], again[n]) for n in got)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_last_only_matches_reference(arch):
    jc, tc, params, tparams = _models(arch)
    jb, tb = _batch(jc, 2, 32)
    want, _ = jt.forward(params, jb, jc, last_only=True)
    got, aux = tt.forward(tparams, tb, tc, last_only=True)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1, jc.vocab_size)
    _check_logits(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch,overrides,seed", [
    ("smollm-135m", {}, 4),
    # StableLM-3B's heads: 80 wide, as many KV heads as query heads.  The
    # batch of seed 6 has its top two reference logits 0.31 apart, so the
    # argmax is compared (seeds 4, 5 and 7 give 0.09: undecided)
    ("stablelm-3b", dict(head_dim=80, n_kv_heads=4), 6),
])
def test_long_branch_matches_reference(arch, overrides, seed):
    """S > ATTN_CHUNK_THRESHOLD: attention goes through ops.flash_attention,
    which on the CPU runs _sdpa_chunked, as the reference runs its own."""
    jc, tc, params, tparams = _models(arch, **overrides)
    if overrides:
        assert (tc.head_dim, tc.n_kv_heads) == (80, tc.n_heads)
    S = 3072
    assert S > tl.ATTN_CHUNK_THRESHOLD
    jb, tb = _batch(jc, 1, S, seed=seed)
    want = jlm.make_prefill_step(jc)(params, jb)
    tops.reset_launch_counts()
    got = tlm.make_prefill_step(tc, device="cpu")(tparams, tb)
    assert tops.LAUNCHES["flash_attention"] == 0
    assert got.shape == (1, jc.vocab_size)
    assert _check_logits(got, want) == 1


@pytest.mark.parametrize("kv_quant", [False, True])
def test_serve_step_matches_reference(kv_quant):
    jc, tc, params, tparams = _models("olmo-1b")
    B, T = 2, 6
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (B, T)).astype(
        np.int32)
    jserve = jax.jit(jlm.make_serve_step(jc))
    tserve = tlm.make_serve_step(tc, device="cpu")
    jc_ = jt.init_cache(jc, B, 8, kv_quant=kv_quant)
    tc_ = tt.init_cache(tc, B, 8, kv_quant=kv_quant, device="cpu")
    decided = 0
    for t in range(T):
        jlg, jc_ = jserve(params, jc_, jnp.asarray(toks[:, t : t + 1]),
                          jnp.int32(t))
        tlg, tc_ = tserve(tparams, tc_, torch.from_numpy(toks[:, t : t + 1]),
                          t)
        decided += _check_logits(tlg, jlg)
    assert decided >= 3
    want_dtype = torch.int8 if kv_quant else torch.bfloat16
    assert tc_["attn"]["k"].dtype == want_dtype
    # the same keys were written at the same places (int8: dequantized)
    got, want = tc_["attn"]["k"].float(), _np(jc_["attn"]["k"])
    if kv_quant:
        got = got * tc_["attn"]["k_scale"]
        want = want * _np(jc_["attn"]["k_scale"])
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("arch", ["smollm-135m", "olmo-1b", "qwen3-0.6b"])
def test_decode_matches_forward(arch):
    """Step-by-step decode reproduces the full forward logits (the
    reference's test_decode_matches_forward, on the port alone)."""
    _, tc, _, tparams = _models(arch)
    B, T = 2, 6
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tc.vocab_size, (B, T)))
    full, _ = tt.forward(tparams, {"tokens": toks}, tc)
    serve = tlm.make_serve_step(tc, device="cpu")
    cache = tt.init_cache(tc, B, 8, device="cpu")
    for t in range(T):
        lg, cache = serve(tparams, cache, toks[:, t : t + 1], t)
    np.testing.assert_allclose(full[:, -1].float().numpy(),
                               lg.float().numpy(), atol=1e-3, rtol=1e-3)


def test_greedy_generate_matches_reference():
    jc, tc, params, tparams = _models("smollm-135m")
    prompt = np.random.default_rng(9).integers(0, jc.vocab_size, (2, 4)
                                               ).astype(np.int32)
    want = jlm.greedy_generate(params, jc, jnp.asarray(prompt), n_new=6)
    got = tlm.greedy_generate(tparams, tc, torch.from_numpy(prompt), 6,
                              device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the int8 cache generates from the same prompt too
    q8 = tlm.greedy_generate(tparams, tc, torch.from_numpy(prompt), 6,
                             kv_quant=True, device="cpu")
    np.testing.assert_array_equal(q8[:, :4].numpy(), prompt)


# ------------------------------------------- the families ported last
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "falcon-mamba-7b",
                                  "zamba2-2.7b"])
def test_unported_families_raise(arch):
    """The moe, ssm and hybrid families, which these entry points refused
    until they were ported, now build the reference's trees: the
    parameters name for name with their shapes, and the decode cache
    (tests/test_torch_families.py holds them against the reference)."""
    jc = jconfigs.reduced(jconfigs.ARCHS[arch])
    tc = tconfigs.reduced(tconfigs.ARCHS[arch])
    want = {".".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.eval_shape(lambda k: jt.init_params(jc, k), KEY))[0]}
    got = tt.init_params(tc, torch.Generator().manual_seed(0)).state_dict()
    assert sorted(got) == sorted(want)
    assert all(tuple(got[n].shape) == want[n].shape for n in want)
    want = {".".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jt.init_cache(jc, 1, 4, abstract=True))[0]}
    cache = tt.init_cache(tc, 1, 4, device="cpu")
    got = {f"{a}.{b}": t for a, sub in cache.items() for b, t in sub.items()}
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype)[6:] == str(leaf.dtype), name


def test_sequence_sharded_decode_raises():
    _, tc, _, tparams = _models("smollm-135m")
    cache = tt.init_cache(tc, 1, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        tt.decode_step(tparams, cache, torch.zeros((1, 1), dtype=torch.int64),
                       0, tc, seq_shard_axes=("model",))


def test_entry_points_need_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    tc = tconfigs.reduced(tconfigs.ARCHS["smollm-135m"])
    tparams = tt.init_params(tc, torch.Generator().manual_seed(0))
    prompt = torch.zeros((1, 2), dtype=torch.int64)
    for call in (lambda: tlm.make_prefill_step(tc),
                 lambda: tlm.make_serve_step(tc),
                 lambda: tlm.greedy_generate(tparams, tc, prompt, 1),
                 lambda: tt.init_cache(tc, 1, 4),
                 lambda: convert.params_from_jax({"w": np.zeros(2)})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
