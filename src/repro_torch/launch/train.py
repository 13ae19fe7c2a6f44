"""LM train launcher — torch twin of ``repro.launch.train``: the train step
with its microbatches, on one device or a data x model mesh, and a
checkpointed loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 50 --batch 8 --seq 128 [--reduced] [--microbatches 2] \
        [--ckpt $TMPDIR/ck] [--device cpu]

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch smollm-135m --reduced --mesh 2x2 --device cpu

The command line is the reference's plus ``--device`` (default: the CUDA
card).  ``--mesh DxM`` other than 1x1 trains on a ("data", "model")
DTensor mesh, one process per rank under ``torch.distributed`` (started
by ``torchrun``, or any launcher that sets its environment): NCCL on
cards (rank r on card ``LOCAL_RANK``), gloo on the CPU.  D x M must equal
the world size.  Parameters and optimizer state are sharded as the
reference's ``param_specs`` say (TP over model, ZeRO-3 over data), the
batch over data.  A checkpoint is written every 50 steps into ``--ckpt``,
and a rerun with the same ``--ckpt`` resumes from the latest one (on any
mesh).  Only rank 0 prints.
"""
from __future__ import annotations

import argparse
import os
import time


def _mesh(spec: str | None) -> tuple[int, int]:
    d, m = (int(x) for x in (spec or "1x1").split("x"))
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {spec}: D and M must be positive")
    return d, m


def _join(d: int, m: int, device: str | None):
    """The process group of a D x M mesh (started from the environment
    unless one is up) -> (mesh, this rank's device).  Raises ValueError
    unless the world size is D x M."""
    import torch
    import torch.distributed as dist

    from .mesh import make_mesh
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if d * m != world:
        raise ValueError(f"--mesh {d}x{m} needs {d * m} ranks; the world "
                         f"size is {world} (start one process per rank, "
                         f"e.g. torchrun --nproc-per-node {d * m})")
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("gloo" if cpu else "nccl")
    return make_mesh((d, m), ("data", "model"), dev.type), dev


def main(argv=None) -> int:
    import numpy as np
    import torch

    from ..configs import ARCHS, reduced as reduce_cfg
    from ..core.device import resolve_device
    from ..data import tokens as token_data
    from ..models import lm, transformer
    from ..models.layers import NO_SHARD, Shardings
    from ..train import checkpoint as ckpt_lib
    from ..train.optimizer import adamw
    from .mesh import distribute, named

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default=None,
                    help="DxM (e.g. 2x2; default 1x1, one device): one "
                         "process per rank")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the config for CPU development")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_cfg(cfg)
    d, m = _mesh(args.mesh)
    if d * m > 1:
        mesh, dev = _join(d, m, args.device)
        sh = Shardings(batch=("data",), model=("model",), fsdp=("data",),
                       model_size=m)
        rank0 = mesh.get_rank() == 0
    else:
        mesh, dev, sh, rank0 = None, resolve_device(args.device), NO_SHARD, True
    say = print if rank0 else (lambda *a, **k: None)
    say(f"mesh {d}x{m}; arch {cfg.arch} ({cfg.n_params()/1e6:.1f}M params)")

    opt = adamw(lr=args.lr, warmup=min(20, args.steps // 10),
                total_steps=args.steps)
    params = transformer.as_tree(transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0)))
    step0 = torch.zeros((), dtype=torch.int32, device=dev)
    shard_tree = None
    if mesh is not None:
        pspecs = transformer.param_specs(cfg, sh)
        params = distribute(params, mesh, pspecs)
        shard_tree = (named(mesh, pspecs),
                      {"m": named(mesh, pspecs), "v": named(mesh, pspecs)},
                      dev)
    state = (params, opt.init(params), step0)
    start = 0
    if args.ckpt and (s := ckpt_lib.latest_step(args.ckpt)) is not None:
        state, extra = ckpt_lib.restore(args.ckpt, s, state,
                                        sharding_tree=shard_tree)
        start = int(extra.get("next_step", s))
        say(f"restored checkpoint @ step {start}")

    step_fn = lm.make_train_step(cfg, opt, num_microbatches=args.microbatches,
                                 device=dev, sh=sh)
    for step in range(start, args.steps):
        toks, labels = token_data.batch_for_step(
            step, global_batch=args.batch, seq_len=args.seq,
            vocab_size=cfg.vocab_size)
        batch = {"tokens": torch.from_numpy(toks % cfg.vocab_size),
                 "labels": torch.from_numpy(labels % cfg.vocab_size)}
        if cfg.input_kind == "embeds":
            rng = np.random.default_rng(step)
            emb = rng.standard_normal(
                (args.batch, args.seq, cfg.d_model)).astype("f") * 0.02
            batch = {"embeds": torch.from_numpy(emb).to(torch.bfloat16),
                     "labels": batch["labels"]}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            say(f"step {step:>5} loss {loss:.4f} "
                f"({dt*1e3:.0f} ms/step)")
        if args.ckpt and (step + 1) % 50 == 0:
            ckpt_lib.save(args.ckpt, step + 1, state,
                          extra={"next_step": step + 1})
    say("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
