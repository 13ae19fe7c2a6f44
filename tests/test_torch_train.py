"""The port's training substrate (``repro_torch.data.tokens``,
``repro_torch.train``: the optimizers, the checkpoints, the Trainer;
``launch/train.py`` and ``examples/train_lm_torch.py``) against the
reference's on the CPU.

Tolerances, and why they are that size:
  * ``batch_for_step``, the Trainer's batches and the checkpoint files:
    bit for bit (numpy, and the same bf16 rounding of the embeds);
  * ``cosine_schedule``: 1e-6 relative and 1e-6 of the base rate
    (float32 ``cos`` an ulp apart; near the end of the decay 1 + cos
    cancels, so an ulp of cos is a larger share of the rate);
  * one optimizer update on equal inputs: 1e-5 relative, 1e-9 absolute
    (float32 arithmetic in another order: the global norm's sum over
    leaves, the means of Adafactor's factored second moment);
  * one train step against the reference's on the same weights and batch:
    the optimizer state's leaves within ``GRAD_RTOL`` of their RMS (they
    are the gradients, bf16 in both packages, see
    ``tests/test_torch_grads.py``; Adam's v squares them, doubling the
    relative error), and the parameters within ``STEP_ATOL`` x the
    learning rate: a step moves a parameter by about the learning rate,
    and a gradient element near 0 can take the other sign in one package;
  * the Trainer restarted from its checkpoint against an unbroken run:
    bit for bit, the reference's contract (``repro/train/checkpoint.py``).
"""
import json
import os
import re
import runpy
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import tokens as jtokens
from repro.models import lm as jlm
from repro.models import transformer as jt
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import configs as tconfigs
from repro_torch.core.tree import leaves, tree_map
from repro_torch.data import tokens as ttokens
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert, lm as tlm
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import FaultInjector, Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent
DENSE, ENCODER = "smollm-135m", "hubert-xlarge"
OPT_RTOL, OPT_ATOL = 1e-5, 1e-9
GRAD_RTOL = 0.05
STEP_ATOL = 2.5
LR = 3e-4
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


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("step,gb,seq,vocab,seed,shard,shards", [
    (0, 8, 16, 100, 0, 0, 1), (7, 8, 16, 100, 3, 1, 2),
    (123, 4, 129, 49152, 5, 3, 4), (2, 2, 1, 2, 0, 0, 1)])
def test_batch_for_step_bit_for_bit(step, gb, seq, vocab, seed, shard,
                                    shards):
    kw = dict(global_batch=gb, seq_len=seq, vocab_size=vocab, seed=seed,
              shard_index=shard, num_shards=shards)
    for got, want in zip(ttokens.batch_for_step(step, **kw),
                         jtokens.batch_for_step(step, **kw)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_batch_for_step_refuses_uneven_shards():
    with pytest.raises(ValueError, match="num_shards"):
        ttokens.batch_for_step(0, global_batch=6, seq_len=4, vocab_size=9,
                               num_shards=4)


# ------------------------------------------------------------- optimizer
def test_cosine_schedule_matches_reference():
    for base, warm, total in ((1e-3, 10, 100), (3e-4, 0, 5), (0.5, 3, 3)):
        got = topt.cosine_schedule(base, warm, total)
        want = jopt.cosine_schedule(base, warm, total)
        for step in range(total + 3):
            g = got(torch.tensor(step, dtype=torch.int32))
            assert g.dtype == torch.float32
            np.testing.assert_allclose(float(g), float(want(jnp.int32(step))),
                                       rtol=1e-6, atol=1e-6 * base)


def _opt_inputs(seed, scale):
    """Params, grads and a non-zero state seed: a 1-D, a 2-D and a 3-D leaf
    in a nested dict; ``scale`` sizes the gradients (large: clipped)."""
    rng = np.random.default_rng(seed)
    shapes = {"b": {"w": (4, 3), "v": (5,)}, "a": (2, 3, 4)}

    def draw(s, k=1.0, positive=False):
        if isinstance(s, dict):
            return {n: draw(x, k, positive) for n, x in s.items()}
        a = rng.standard_normal(s).astype(np.float32) * k
        return np.abs(a) if positive else a
    return draw(shapes), draw(shapes, scale), rng


def _tree(np_tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in np_tree.items()}


def _assert_trees(got, want, rtol=OPT_RTOL, atol=OPT_ATOL):
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["unclipped",
                                                    "clipped"])
@pytest.mark.parametrize("step", [0, 7])
def test_adamw_update_matches_reference(scale, step):
    params, grads, rng = _opt_inputs(1, scale)
    state = {"m": _tree(params, lambda a: a * 0.1),
             "v": _tree(params, lambda a: np.abs(a) * 0.01)}
    kw = dict(lr=1e-2, warmup=3, total_steps=20, weight_decay=0.1)
    t, j = topt.adamw(**kw), jopt.adamw(**kw)
    tt_ = lambda tree: _tree(tree, torch.from_numpy)
    jj = lambda tree: _tree(tree, jnp.asarray)
    gu, gs = t.update(tt_(grads), {k: tt_(v) for k, v in state.items()},
                      tt_(params), torch.tensor(step, dtype=torch.int32))
    wu, ws = j.update(jj(grads), {k: jj(v) for k, v in state.items()},
                      jj(params), jnp.int32(step))
    _assert_trees(gu, wu)
    _assert_trees(gs, ws)
    np.testing.assert_allclose(float(t.global_norm(tt_(grads))),
                               float(j.global_norm(jj(grads))), rtol=1e-6)
    if scale > 1:
        assert float(t.global_norm(tt_(grads))) > kw.get("clip_norm", 1.0)


@pytest.mark.parametrize("clip", [1.0, 0.05], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("step", [0, 7])
def test_adafactor_update_matches_reference(clip, step):
    """Matrices take the factored rule (``p.ndim >= 2``: the 2-D and 3-D
    leaves keep ``vr`` and ``vc``), the vector its whole second moment; at
    ``clip`` 0.05 every update's RMS is cut to it."""
    params, grads, rng = _opt_inputs(2, 1.0)
    kw = dict(lr=1e-2, warmup=2, total_steps=20, weight_decay=0.1,
              clip_threshold=clip)
    t, j = topt.adafactor(**kw), jopt.adafactor(**kw)
    tp = _tree(params, torch.from_numpy)
    jp = _tree(params, jnp.asarray)
    ts, js = t.init(tp), j.init(jp)
    _assert_trees(ts, js, rtol=0, atol=0)
    assert tuple(ts["a"]["vr"].shape) == (2, 3)
    assert tuple(ts["a"]["vc"].shape) == (2, 4)
    assert tuple(ts["b"]["v"]["vc"].shape) == ()
    # a non-zero state: one update first, then the compared one
    tg, jg = _tree(grads, torch.from_numpy), _tree(grads, jnp.asarray)
    _, ts = t.update(tg, ts, tp, torch.tensor(0, dtype=torch.int32))
    _, js = j.update(jg, js, jp, jnp.int32(0))
    gu, gs = t.update(tg, ts, tp, torch.tensor(step, dtype=torch.int32))
    wu, ws = j.update(jg, js, jp, jnp.int32(step))
    _assert_trees(gu, wu)
    _assert_trees(gs, ws)
    if clip < 1:
        lr_t = float(t_lr(kw, step))
        for u in leaves(gu):
            assert float(u.square().mean().sqrt()) <= lr_t * (clip + 0.1)


def t_lr(kw, step):
    return topt.cosine_schedule(kw["lr"], kw["warmup"],
                                kw["total_steps"])(step)


@pytest.fixture(scope="module")
def dense_models():
    jc = jconfigs.reduced(jconfigs.ARCHS[DENSE])
    tc = tconfigs.reduced(tconfigs.ARCHS[DENSE])
    params = jax.tree.map(np.asarray, jt.init_params(jc, jax.random.key(0)))
    return jc, tc, params


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_step_matches_reference(name, dense_models):
    """One ``make_train_step`` (two microbatches) on the reference's weights
    and batch: the new parameters, the optimizer state and the metrics."""
    jc, tc, params = dense_models
    kw = dict(lr=LR, warmup=0, total_steps=10)
    t, j = getattr(topt, name)(**kw), getattr(jopt, name)(**kw)
    toks, labels = jtokens.batch_for_step(0, global_batch=4, seq_len=32,
                                          vocab_size=jc.vocab_size)
    tp = convert.params_from_jax(params, device="cpu").tree()
    jp = jax.tree.map(jnp.asarray, params)
    (gp, gs, gstep), gm = tlm.make_train_step(
        tc, t, num_microbatches=2, device="cpu")(
        (tp, t.init(tp), torch.tensor(0, dtype=torch.int32)),
        {"tokens": torch.from_numpy(toks),
         "labels": torch.from_numpy(labels)})
    (wp, ws, wstep), wm = jax.jit(jlm.make_train_step(
        jc, j, num_microbatches=2))(
        (jp, j.init(jp), jnp.int32(0)),
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    assert int(gstep) == int(wstep) == 1 and gstep.dtype == torch.int32
    for k in ("loss", "ce", "moe_aux"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=5e-4,
                                   atol=1e-6)
    np.testing.assert_allclose(float(gm["grad_norm"]),
                               float(wm["grad_norm"]), rtol=GRAD_RTOL)
    for a, b in zip(leaves(gp), jax.tree.leaves(wp)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                   atol=STEP_ATOL * LR)
    for a, b in zip(leaves(gs), jax.tree.leaves(ws)):
        a, b = _np(a).astype(np.float64), np.asarray(b, np.float64)
        rms = np.sqrt(np.mean(b ** 2))
        assert np.sqrt(np.mean((a - b) ** 2)) <= 2 * GRAD_RTOL * rms


# ----------------------------------------------------------- checkpoints
def _state(seed=0):
    rng = np.random.default_rng(seed)
    params = {"b": {"w": rng.standard_normal((3, 2)).astype(np.float32)},
              "a": rng.standard_normal((4,)).astype(np.float32)}
    opt = {"m": {"b": {"w": np.ones((3, 2), np.float32)},
                 "a": np.zeros(4, np.float32)},
           "v": {"b": {"w": np.full((3, 2), 2.0, np.float32)},
                 "a": np.arange(4, dtype=np.float32)}}
    return params, opt, np.int32(5)


def _torch_state(seed=0):
    p, o, s = _state(seed)
    to = lambda t: _tree(t, torch.from_numpy)
    return to(p), {k: to(v) for k, v in o.items()}, torch.tensor(
        s, dtype=torch.int32)


def test_checkpoint_round_trip_and_retention(tmp_path):
    d = str(tmp_path)
    state = _torch_state()
    for step in (1, 2, 3, 4):
        tckpt.save(d, step, state, extra={"next_step": step}, keep=2)
    assert tckpt.all_steps(d) == [3, 4] and tckpt.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_000000000003",
                                     "step_000000000004"]
    like = tree_map(torch.zeros_like, state)
    got, extra = tckpt.restore(d, 4, like)
    assert extra == {"next_step": 4}
    assert isinstance(got, tuple) and got[2].dtype == torch.int32
    assert all(torch.equal(a, b) for a, b in zip(leaves(got),
                                                 leaves(state)))
    assert tckpt.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_refuses_mismatches(tmp_path):
    d = str(tmp_path)
    tckpt.save(d, 1, {"a": torch.ones(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(d, 1, {"a": torch.ones(3, 3)})
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore(d, 1, {"a": torch.ones(2, 3), "b": torch.ones(1)})


def test_checkpoint_is_atomic(tmp_path):
    """A leftover ``tmp.<step>`` is not a checkpoint; saving a step that
    exists keeps the first."""
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "tmp.9"))
    assert tckpt.latest_step(d) is None
    tckpt.save(d, 2, {"a": torch.ones(2)})
    tckpt.save(d, 2, {"a": torch.zeros(2)})
    got, _ = tckpt.restore(d, 2, {"a": torch.empty(2)})
    assert torch.equal(got["a"], torch.ones(2))
    assert not any(n.startswith("tmp.2") for n in os.listdir(d))


def test_checkpoints_cross_packages(tmp_path):
    """A checkpoint written by either package restores in the other: the
    same ``leaf_i`` in ``jax.tree`` order and the same ``meta.json`` keys,
    equal but for ``treedef``, which neither ``restore`` reads."""
    jstate = jax.tree.map(jnp.asarray, _state(1))
    tstate = _torch_state(1)
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(jd, 3, jstate, extra={"next_step": 3})
    tckpt.save(td, 3, tstate, extra={"next_step": 3})
    with open(os.path.join(jd, "step_000000000003", "meta.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(td, "step_000000000003", "meta.json")) as f:
        tmeta = json.load(f)
    assert jmeta.keys() == tmeta.keys()
    assert {k: v for k, v in jmeta.items() if k != "treedef"} == {
        k: v for k, v in tmeta.items() if k != "treedef"}
    with np.load(os.path.join(jd, "step_000000000003", "arrays.npz")) as a, \
            np.load(os.path.join(td, "step_000000000003",
                                 "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    got, extra = tckpt.restore(jd, 3, tree_map(torch.zeros_like, tstate))
    assert extra == {"next_step": 3}
    for a, b in zip(leaves(got), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    back, _ = jckpt.restore(td, 3, jax.tree.map(jnp.zeros_like, jstate))
    for a, b in zip(jax.tree.leaves(back), leaves(tstate)):
        np.testing.assert_array_equal(np.asarray(a), _np(b))


# ---------------------------------------------------------------- trainer
CFG = tconfigs.reduced(tconfigs.ARCHS[DENSE])


def _tcfg(**kw):
    base = dict(total_steps=8, global_batch=4, seq_len=32, log_every=2,
                seed=5)
    return TrainerConfig(**dict(base, **kw))


class _Recorder:
    """A train step that records the steps and batches it is given."""

    def __init__(self, step_fn):
        self.step_fn, self.seen = step_fn, []

    def __call__(self, state, batch):
        self.seen.append((int(state[2]), {k: v.clone()
                                          for k, v in batch.items()}))
        return self.step_fn(state, batch)


def test_trainer_failures_and_restart_bit_for_bit(tmp_path):
    """Injected failures at steps 2 and 5 are replayed on the same state;
    the run ends on the unbroken run's state, bit for bit.  A new Trainer
    restored from the checkpoint after step 3 replays steps 4-7 on the
    unbroken run's batches and ends on its state, bit for bit."""
    d = str(tmp_path / "ck")
    faulty = Trainer(CFG, _tcfg(ckpt_dir=d, ckpt_every=4),
                     fault_injector=FaultInjector(fail_steps=(2, 5)),
                     device="cpu")
    got = faulty.run()
    assert faulty.faults.tripped == {2, 5}
    plain = Trainer(CFG, _tcfg(), device="cpu")
    rec = _Recorder(plain.train_step)
    plain.train_step = rec
    want = plain.run()
    assert int(got[2]) == int(want[2]) == 8
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
    assert [m["loss"] for m in faulty.metrics_log] == [
        m["loss"] for m in plain.metrics_log]
    assert tckpt.all_steps(d) == [4, 8]

    again = str(tmp_path / "again")
    shutil.copytree(os.path.join(d, "step_000000000004"),
                    os.path.join(again, "step_000000000004"))
    restart = Trainer(CFG, _tcfg(ckpt_dir=again, ckpt_every=0),
                      device="cpu")
    rec2 = _Recorder(restart.train_step)
    restart.train_step = rec2
    final = restart.run()
    assert [s for s, _ in rec2.seen] == [4, 5, 6, 7]
    for (s, b), (s0, b0) in zip(rec2.seen, rec.seen[4:]):
        assert s == s0 and all(torch.equal(b[k], b0[k]) for k in b)
    assert all(torch.equal(a, b) for a, b in zip(leaves(final),
                                                 leaves(want)))


@pytest.mark.parametrize("error", [tops.KernelLaunchError,
                                   RuntimeError])
def test_trainer_raises_kernel_errors_at_once(error):
    """A kernel's fault is raised on its first occurrence; any other
    ``RuntimeError`` is replayed (``max_retries``)."""
    calls = []
    inner = tlm.make_train_step(CFG, topt.adamw(total_steps=2),
                                device="cpu")

    def step(state, batch):
        calls.append(1)
        if len(calls) == 1:
            raise error("launch failed")
        return inner(state, batch)
    t = Trainer(CFG, _tcfg(total_steps=1), train_step_fn=step,
                device="cpu")
    if error is tops.KernelLaunchError:
        with pytest.raises(tops.KernelLaunchError):
            t.run()
        assert len(calls) == 1
    else:
        assert int(t.run()[2]) == 1 and len(calls) == 2


@pytest.mark.parametrize("arch", [DENSE, ENCODER])
def test_trainer_batches_match_reference(arch):
    """``Trainer.batch_for``, tokens and the encoder's pseudo-embeddings
    (``default_rng(step + seed)``, rounded to bf16), bit for bit."""
    jc = jconfigs.reduced(jconfigs.ARCHS[arch])
    tc = tconfigs.reduced(tconfigs.ARCHS[arch])
    kw = dict(global_batch=2, seq_len=8, seed=3)
    ref = jtrainer.Trainer(jc, jtrainer.TrainerConfig(**kw))
    port = Trainer(tc, TrainerConfig(**kw), device="cpu")
    for step in (0, 4):
        want, got = ref.batch_for(step), port.batch_for(step)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(
                got[k].float().numpy() if k == "embeds" else got[k].numpy(),
                np.asarray(want[k], np.float32) if k == "embeds"
                else np.asarray(want[k]))
            if k == "embeds":
                assert got[k].dtype == torch.bfloat16


def test_trainer_init_state_from_a_generator():
    t = Trainer(CFG, _tcfg(), device="cpu")
    a = t.init_state(torch.Generator().manual_seed(1))
    b = t.init_state(torch.Generator().manual_seed(1))
    c = t.init_state()
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not torch.equal(a[0]["lm_head"], c[0]["lm_head"])
    assert a[2].dtype == torch.int32 and int(a[2]) == 0
    assert not any(p.requires_grad for p in leaves(a[0]))


# ------------------------------------------------------ launcher, example
def _launch(argv, capsys):
    assert tlaunch.main(argv) == 0
    return capsys.readouterr().out.splitlines()


def test_train_launcher_lines_and_restart(tmp_path, capsys):
    """The reference's lines (``mesh``, ``step ... loss ... (... ms/step)``,
    ``done``); a rerun with ``--ckpt`` prints ``restored checkpoint @ step
    50`` and goes on from there."""
    ck = str(tmp_path / "ck")
    base = ["--arch", DENSE, "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "8", "--ckpt", ck]
    out = _launch(base + ["--steps", "50"], capsys)
    assert out[0] == "mesh 1x1; arch smollm-135m (0.7M params)"
    steps = [ln for ln in out if ln.startswith("step")]
    assert len(steps) == 11 and out[-1] == "done"
    assert all(re.fullmatch(r"step +\d+ loss \d+\.\d{4} \(\d+ ms/step\)",
                            ln) for ln in steps)
    assert tckpt.all_steps(ck) == [50]
    out = _launch(base + ["--steps", "52", "--microbatches", "2"], capsys)
    assert out[1] == "restored checkpoint @ step 50"
    assert [ln.split()[1] for ln in out if ln.startswith("step")] == [
        "50", "51"]


def test_train_lm_torch_example(tmp_path, monkeypatch, capsys):
    """The twin example on the CPU, run as a script in this process, at 30
    steps (its injected failure at step 57 lies past them; the Trainer's
    replay is held above): the loss falls (its own assert) and a
    checkpoint is written at the end."""
    ck = str(tmp_path / "ck")
    monkeypatch.setattr(sys, "argv", [
        "train_lm_torch.py", "--steps", "30", "--device", "cpu", "--ckpt",
        ck])
    runpy.run_path(str(ROOT / "examples" / "train_lm_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "injected failure at step 57" in out
    assert re.search(r"loss \d+\.\d+ -> \d+\.\d+ OK", out)
    assert tckpt.all_steps(ck) == [30]
