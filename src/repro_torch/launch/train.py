"""LM train launcher — torch twin of ``repro.launch.train``: the train step
with its microbatches and a checkpointed loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 50 --batch 8 --seq 128 [--reduced] [--microbatches 2] \
        [--ckpt /tmp/ck] [--device cpu]

The command line is the reference's plus ``--device`` (default: the CUDA
card).  ``--mesh`` takes only ``1x1``, one device: the production mesh
(data x model sharding) waits for ROADMAP Queue 1 item 11.2.  A
checkpoint is written every 50 steps into ``--ckpt``, and a rerun with
the same ``--ckpt`` resumes from the latest one.
"""
from __future__ import annotations

import argparse
import time


def _mesh(spec: str | None) -> tuple[int, int]:
    d, m = (int(x) for x in (spec or "1x1").split("x"))
    if (d, m) != (1, 1):
        raise NotImplementedError(
            f"--mesh {spec}: the port trains on one device (1x1); the "
            f"production mesh is ROADMAP Queue 1 item 11.2")
    return d, m


def main(argv=None) -> int:
    import numpy as np
    import torch

    from ..configs import ARCHS, reduced as reduce_cfg
    from ..core.device import resolve_device
    from ..data import tokens as token_data
    from ..models import lm, transformer
    from ..train import checkpoint as ckpt_lib
    from ..train.optimizer import adamw

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default=None,
                    help="DxM; only 1x1 (one device) is ported")
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
    dev = resolve_device(args.device)
    print(f"mesh {d}x{m}; arch {cfg.arch} ({cfg.n_params()/1e6:.1f}M params)")

    opt = adamw(lr=args.lr, warmup=min(20, args.steps // 10),
                total_steps=args.steps)
    params = transformer.as_tree(transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0)))
    state = (params, opt.init(params),
             torch.zeros((), dtype=torch.int32, device=dev))
    start = 0
    if args.ckpt and (s := ckpt_lib.latest_step(args.ckpt)) is not None:
        state, extra = ckpt_lib.restore(args.ckpt, s, state)
        start = int(extra.get("next_step", s))
        print(f"restored checkpoint @ step {start}")

    step_fn = lm.make_train_step(cfg, opt, num_microbatches=args.microbatches,
                                 device=dev)
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
            print(f"step {step:>5} loss {loss:.4f} "
                  f"({dt*1e3:.0f} ms/step)")
        if args.ckpt and (step + 1) % 50 == 0:
            ckpt_lib.save(args.ckpt, step + 1, state,
                          extra={"next_step": step + 1})
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
