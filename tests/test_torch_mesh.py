"""The production mesh on the CPU: the sequence-sharded decode, the sharded
train step, elastic checkpoints and the sharded launcher.

* The local form of the sequence-sharded decode (N logical shards of the
  one cache, combined by a reduction over the shard dim) on
  ``reduced(zamba2-2.7b)`` at S=64, 6 tokens, on the reference's weights:
  within the reference's own bar, 0.05 (``tests/test_distributed.py``'s
  long-context check), of the reference's unsharded ``decode_step``, and
  within 2^-5 (two bf16 steps at the logits' scale, |logit| < 4) of the
  port's unsharded decode, whose softmax normalises before its P.V
  product where the flash-decode divides after.  At 64 shards each token
  sits in a shard of its own; one shard's stats left out of the combine
  must fail the bar.
* One gloo subprocess of 4 ranks holds:
  - one train step (adamw from step 0, 2 microbatches, remat) of
    ``reduced(olmo-1b)`` on the reference's weights and one batch, on one
    device, on a (2, 2) and on a (4, 1) (data, model) mesh: the loss, the
    grad norm, every gradient leaf the optimizer is given (pinned to its
    parameter's layout) and every updated parameter leaf, gathered whole,
    against the unsharded step (``SHARD_STEP_TOL``) and against the
    reference's ``make_train_step`` (``REF_STEP_TOL``); two planted faults
    on (2, 2) must fail both: the embedding's gradient taken as replicated
    where each data rank holds a partial sum, and data shard 1's rows
    dropped (shard 0's counted twice);
  - a checkpoint saved on (2, 2) and restored onto (4, 1) taking the next
    step within the reference's 1e-3 of the uninterrupted run;
  - the group form of the sequence-sharded decode (one shard a data rank)
    equal to the local form bit for bit, and the fully sharded serve step
    within 0.05 of it;
  - ``launch/train.py --mesh 2x2``.

Step tolerances (readings on this CPU, olmo-1b reduced, 8 rows of 32):
  * loss, relative: 4e-4 against either (readings 8.7e-5 sharded against
    unsharded, 8.8e-5 the port against the reference: bf16 rounding moved
    by the model-dim split of the contractions; rows dropped 3.2e-3);
  * grad norm, relative: 5e-3 (readings 7.4e-4 and 5.4e-4; faults 0.25
    and 0.53);
  * each gradient leaf, RMS of the difference over the leaf's RMS: 0.05,
    ``tests/test_torch_grads.py``'s bar against the reference (readings:
    2.3% (2, 2) against unsharded, 0.36% (4, 1), 2.0-2.3% against the
    reference; faults 71% and 103%);
  * each update leaf (new parameters less old), the same measure: 0.3.
    At step 0 adamw's update is lr * g / (|g| + eps), about lr * sign(g),
    so an element whose gradient sits within bf16 noise of 0 flips sign
    and a 0.7% share of flips reads 0.17 (readings 0.17 (2, 2), 0.047
    (4, 1), 0.17 against the reference; faults 0.76 and 0.99).
"""
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import transformer as jt
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert, layers as tl, lm as tlm
from repro_torch.models import transformer as tt

ROOT = Path(__file__).resolve().parent.parent
HYBRID = "zamba2-2.7b"
S, STEPS = 64, 6
REF_TOL = 0.05
PORT_TOL = 2.0 ** -5
TRAIN_ARCH = "olmo-1b"
SHARD_STEP_TOL = dict(loss=4e-4, grad_norm=5e-3, grads=0.05, updates=0.3)
REF_STEP_TOL = SHARD_STEP_TOL


@pytest.fixture(scope="module")
def hybrid():
    torch.set_num_threads(2)
    jc = jconfigs.reduced(jconfigs.ARCHS[HYBRID])
    tc = tconfigs.reduced(tconfigs.ARCHS[HYBRID])
    params = jax.tree.map(np.asarray, jt.init_params(jc, jax.random.key(0)))
    toks = np.random.default_rng(0).integers(0, tc.vocab_size,
                                             (1, STEPS)).astype(np.int32)
    serve = jax.jit(jlm.make_serve_step(jc))
    cache = jt.init_cache(jc, 1, S)
    for t in range(STEPS):
        lg, cache = serve(params, cache, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t))
    return tc, convert.params_from_jax(params, device="cpu"), toks, \
        np.asarray(lg, np.float32)


def _decode(tc, tp, toks, seq_shard_axes):
    cache = tt.init_cache(tc, 1, S, device="cpu")
    serve = tlm.make_serve_step(tc, seq_shard_axes=seq_shard_axes,
                                device="cpu")
    for t in range(STEPS):
        lg, cache = serve(tp, cache, torch.from_numpy(toks[:, t:t + 1]), t)
    return lg.float().numpy()


class _DropShard(tl.LocalSeqShards):
    """A planted fault: shard ``j``'s num and den left out of the sums."""

    def __init__(self, n, j):
        super().__init__(n)
        self.j = j

    def sum(self, x):
        keep = torch.ones(self.n, dtype=x.dtype)
        keep[self.j] = 0
        return (x * keep.view((1, -1) + (1,) * (x.dim() - 2))).sum(
            1, keepdim=True)


@pytest.mark.parametrize("n", [1, 8, 64])
def test_local_sequence_sharded_decode(hybrid, n):
    tc, tp, toks, ref = hybrid
    got = _decode(tc, tp, toks, n)
    plain = _decode(tc, tp, toks, ())
    d_ref = float(np.abs(got - ref).max())
    d_port = float(np.abs(got - plain).max())
    assert d_ref < REF_TOL, d_ref
    assert d_port < PORT_TOL, d_port
    assert (got.argmax(-1) == plain.argmax(-1)).all()


def test_local_decode_planted_fault_fails(hybrid):
    tc, tp, toks, ref = hybrid
    for j in (0, 3):
        bad = _decode(tc, tp, toks, _DropShard(64, j))
        assert float(np.abs(bad - ref).max()) > REF_TOL, j


def test_local_decode_refuses_an_uneven_cut(hybrid):
    tc, tp, toks, _ = hybrid
    with pytest.raises(ValueError, match="sequence shards"):
        _decode(tc, tp, toks, 5)


def test_train_launcher_mesh_needs_its_world_size(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tlaunch.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu",
                      "--mesh", "2x2"])


_GLOO_SCRIPT = r'''
import contextlib, dataclasses, os, sys
import torch, torch.distributed as dist
import torch.multiprocessing as mp


@contextlib.contextmanager
def embed_grad_replicated():
    # planted fault: the embedding table's gradient taken as Replicate
    # where each data rank holds only its own tokens' partial sum
    import torch.distributed.tensor as tdt
    keep = tdt.Partial
    tdt.Partial = tdt.Replicate
    try:
        yield
    finally:
        tdt.Partial = keep


@contextlib.contextmanager
def rows_dropped():
    # planted fault: every data shard keeps data shard 0's rows, so shard
    # 1's rows are dropped and shard 0's counted twice
    from torch.distributed.tensor import DTensor
    from repro_torch.models import lm
    keep = lm._lay_out

    def lay(batch, mesh, sh, dev):
        out = keep(batch, mesh, sh, dev)
        return {k: DTensor.from_local(
            torch.as_tensor(batch[k])[:v.to_local().shape[0]], mesh,
            v.placements, run_check=False) for k, v in out.items()}
    lm._lay_out = lay
    try:
        yield
    finally:
        lm._lay_out = keep


def run(rank, port, work):
    import time
    t0 = time.perf_counter()
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=4)
    torch.set_num_threads(1)
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.core.tree import leaves
    from repro_torch.launch import mesh as ml, train as tlaunch
    from repro_torch.models import lm, transformer as tt
    from repro_torch.models.layers import Shardings
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import Optimizer, adamw
    say = (lambda *a: print(f"[{time.perf_counter() - t0:.1f} s]", *a)) \
        if rank == 0 else (lambda *a: None)

    def make(shape):
        mesh = ml.make_mesh(shape, ("data", "model"), "cpu")
        sh = Shardings(batch=("data",), model=("model",), fsdp=("data",),
                       model_size=shape[1])
        return mesh, sh, tt.param_specs(cfg, sh)

    inputs = torch.load(os.path.join(work, "inputs.pt"))
    cfg = dataclasses.replace(reduced(ARCHS["olmo-1b"]), remat=True)
    params = inputs["params"]
    batch = {"tokens": inputs["tokens"], "labels": inputs["labels"]}
    zero = torch.zeros((), dtype=torch.int32)
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t

    # 1. one train step (2 microbatches, remat, adamw from step 0) on one
    # device, on (2, 2), on (4, 1) and on (2, 2) with each planted fault:
    # loss, grad norm, the gradients the optimizer is given and the new
    # parameters, gathered whole for the test to hold against the
    # unsharded step and the reference's
    def one_step(shape, fault=contextlib.nullcontext):
        opt = adamw(warmup=0, total_steps=4)
        seen = []

        def update(g, s, p, t):
            seen.append(g)
            return opt.update(g, s, p, t)
        cap = Optimizer(opt.init, update, opt.global_norm)
        ps, kw = params, {}
        if shape is not None:
            mesh, sh, pspecs = make(shape)
            ps, kw = ml.distribute(params, mesh, pspecs), {"sh": sh}
        with fault():
            (new, _, _), m = lm.make_train_step(
                cfg, cap, num_microbatches=2, device="cpu", **kw)(
                (ps, cap.init(ps), zero), batch)
        if shape is not None:      # pinned to the parameters' layout
            for g, p in zip(leaves(seen[0]), leaves(tt.as_tree(ps))):
                assert g.placements == p.placements, (g.placements,
                                                      p.placements)
        out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "grads": [full(g) for g in leaves(seen[0])],
               "params": [full(p) for p in leaves(new)]}
        say(f"STEP {shape} {fault.__name__} loss {out['loss']:.6f} "
            f"grad_norm {out['grad_norm']:.6f}")
        return out

    steps = {"plain": one_step(None), "2x2": one_step((2, 2)),
             "4x1": one_step((4, 1)),
             "embed_grad_replicated": one_step((2, 2),
                                               embed_grad_replicated),
             "rows_dropped": one_step((2, 2), rows_dropped)}
    if rank == 0:
        torch.save(steps, os.path.join(work, "steps.pt"))

    # 2. elastic, as the reference's script: 2 steps on (2, 2), save, one
    # more; restore on (4, 1) and take the same step
    ckdir = os.path.join(work, "ck")
    opt = adamw(warmup=0, total_steps=6)
    mesh, sh, pspecs = make((2, 2))
    ps = ml.distribute(params, mesh, pspecs)
    state = (ps, opt.init(ps), zero)
    step = lm.make_train_step(cfg, opt, device="cpu", sh=sh)
    for _ in range(2):
        state, _ = step(state, batch)
    ckpt.save(ckdir, 2, state, extra={"next_step": 2})
    _, m_a = step(state, batch)
    mesh2, sh2, pspecs2 = make((4, 1))
    p2 = ml.distribute(params, mesh2, pspecs2)
    like = (p2, opt.init(p2), zero)
    where = (ml.named(mesh2, pspecs2),
             {"m": ml.named(mesh2, pspecs2), "v": ml.named(mesh2, pspecs2)},
             "cpu")
    restored, extra = ckpt.restore(ckdir, 2, like, sharding_tree=where)
    assert extra["next_step"] == 2
    assert restored[0]["lm_head"].placements == p2["lm_head"].placements
    _, m_b = lm.make_train_step(cfg, opt, device="cpu", sh=sh2)(restored,
                                                                batch)
    d = abs(float(m_a["loss"]) - float(m_b["loss"]))
    say(f"ELASTIC loss {float(m_a['loss']):.6f} restored "
        f"{float(m_b['loss']):.6f} |diff| {d:.3g}")
    assert d < 1e-3, d

    # 3. the group form of the sequence-sharded decode: one shard a data
    # rank (heads over model), against the local form of 2 shards
    g = torch.Generator().manual_seed(0)
    hc = reduced(ARCHS["zamba2-2.7b"])
    hp = tt.init_params(hc, torch.Generator().manual_seed(1)).tree()
    htoks = torch.randint(0, hc.vocab_size, (1, 6), generator=g)
    mesh, _, _ = make((2, 2))
    shd = Shardings(batch=(), model=("model",), fsdp=(), model_size=2)
    cspecs = tt.cache_specs(hc, shd, seq_shard_axes=("data",))

    def decode(params, cache, axes, sh=None):
        kw = {"sh": sh} if sh is not None else {}
        serve = lm.make_serve_step(hc, seq_shard_axes=axes, device="cpu",
                                   **kw)
        for t in range(6):
            lg, cache = serve(params, cache, htoks[:, t:t + 1], t)
        return full(lg)

    local = decode(hp, tt.init_cache(hc, 1, 64, device="cpu"), 2)
    cache = tt.init_cache(hc, 1, 64, device="cpu")     # plain params: only
    cache["attn"] = ml.distribute(cache["attn"], mesh,  # the KV cache is cut
                                  cspecs["attn"])
    group = decode(hp, cache, ("data",))
    assert torch.equal(group, local), (group - local).abs().max()
    cache = ml.distribute(tt.init_cache(hc, 1, 64, device="cpu"), mesh,
                          cspecs)
    sharded = decode(ml.distribute(hp, mesh, tt.param_specs(hc, shd)), cache,
                     ("data",), shd)
    d = float((sharded.float() - local.float()).abs().max())
    say(f"GROUP_DECODE equal; sharded params |diff| {d:.3g} "
        f"(max |logit| {float(local.float().abs().max()):.3g}, "
        f"{local.dtype})")
    assert d < 0.05, d

    # 4. the launcher on this group
    assert tlaunch.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu",
                         "--mesh", "2x2", "--steps", "2", "--seq", "32"]) == 0
    dist.barrier()
    say("MESH_OK")
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(int(sys.argv[1]), sys.argv[2]), nprocs=4)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reference_step(jc, weights, tokens, labels):
    """The reference's ``make_train_step`` (adamw from step 0, 2
    microbatches) on ``weights`` -> its loss, grad norm, the gradients its
    optimizer is given and its new parameters, as numpy leaves."""
    opt = jopt.adamw(warmup=0, total_steps=4)

    def update(g, s, p, t):          # the gradients ride in the new state
        u, s = opt.update(g, s["opt"], p, t)
        return u, {"opt": s, "grads": g}
    cap = jopt.Optimizer(lambda p: {"opt": opt.init(p),
                                    "grads": jax.tree.map(jnp.zeros_like, p)},
                         update, opt.global_norm)
    params = jax.tree.map(jnp.asarray, weights)
    step = jax.jit(jlm.make_train_step(jc, cap, num_microbatches=2))
    (new, st, _), m = step((params, cap.init(params), jnp.int32(0)),
                           {"tokens": jnp.asarray(tokens),
                            "labels": jnp.asarray(labels)})
    leaves = lambda t: [np.asarray(x, np.float32) for x in jax.tree.leaves(t)]
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": leaves(st["grads"]), "params": leaves(new)}


def _rel_rms(got, want) -> float:
    """The RMS of ``got - want`` over the RMS of ``want``."""
    w = np.asarray(want, np.float64)
    d = np.asarray(got, np.float64) - w
    return float(np.sqrt(np.mean(d ** 2)) / max(np.sqrt(np.mean(w ** 2)),
                                                1e-30))


def _step_readings(got, want, start) -> dict:
    """How far one train step's results are from another's: the loss and
    grad norm relative, the worst gradient leaf and the worst update leaf
    (new parameters less ``start``) as ``_rel_rms``."""
    return {
        "loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
        "grad_norm": abs(got["grad_norm"] - want["grad_norm"])
        / abs(want["grad_norm"]),
        "grads": max(_rel_rms(g, w) for g, w in zip(got["grads"],
                                                    want["grads"])),
        "updates": max(_rel_rms(np.asarray(g) - p0, np.asarray(w) - p0)
                       for g, w, p0 in zip(got["params"], want["params"],
                                           start)),
    }


def _within(reading: dict, tol: dict) -> bool:
    return all(reading[k] <= tol[k] for k in tol)


def test_gloo_group_of_four(tmp_path):
    """The 4-rank script (module docstring) on the reference's weights and
    batch; then its train steps held here against the unsharded step and
    the reference's, the planted faults failing both."""
    jc = dataclasses.replace(jconfigs.reduced(jconfigs.ARCHS[TRAIN_ARCH]),
                             remat=True)
    weights = jax.tree.map(np.asarray, jt.init_params(jc, jax.random.key(0)))
    rng = np.random.default_rng(0)
    tokens, labels = (rng.integers(0, jc.vocab_size, (8, 32)).astype(np.int32)
                      for _ in range(2))
    torch.save({"params": convert.params_from_jax(weights,
                                                  device="cpu").tree(),
                "tokens": torch.from_numpy(tokens),
                "labels": torch.from_numpy(labels)}, tmp_path / "inputs.pt")
    script = tmp_path / "mesh4.py"
    script.write_text(_GLOO_SCRIPT)
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), str(_free_port()),
                          str(tmp_path)],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    print(out.stdout)
    assert "MESH_OK" in out.stdout, out.stdout

    ref = _reference_step(jc, weights, tokens, labels)
    steps = {k: {**v, "grads": [g.numpy() for g in v["grads"]],
                 "params": [p.numpy() for p in v["params"]]}
             for k, v in torch.load(tmp_path / "steps.pt").items()}
    start = [np.asarray(x, np.float32) for x in jax.tree.leaves(weights)]
    read = {(k, against): _step_readings(steps[k], want, start)
            for k in steps
            for against, want in (("plain", steps["plain"]), ("ref", ref))}
    for k, r in read.items():
        print(k, {m: f"{v:.3g}" for m, v in r.items()})
    assert _within(read[("plain", "ref")], REF_STEP_TOL)
    for mesh in ("2x2", "4x1"):
        assert _within(read[(mesh, "plain")], SHARD_STEP_TOL), mesh
        assert _within(read[(mesh, "ref")], REF_STEP_TOL), mesh
    for fault in ("embed_grad_replicated", "rows_dropped"):
        assert not _within(read[(fault, "plain")], SHARD_STEP_TOL), fault
        assert not _within(read[(fault, "ref")], REF_STEP_TOL), fault
