"""Train a reduced LM config on the port (``repro_torch``) for a few hundred
steps with checkpointing and a mid-run injected failure (the fault-tolerance
path, end to end) — the twin of ``examples/train_lm.py``.

    python examples/train_lm_torch.py [--arch smollm-135m --steps 300]
        [--device cpu]                      # default: the CUDA card
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    FaultInjector, Trainer, TrainerConfig)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    cfg = reduced(ARCHS[args.arch])
    tcfg = TrainerConfig(total_steps=args.steps, global_batch=8, seq_len=128,
                         ckpt_dir=args.ckpt, ckpt_every=100, log_every=25)
    trainer = Trainer(cfg, tcfg,
                      fault_injector=FaultInjector(fail_steps=(57,)),
                      device=args.device)
    print(f"training reduced {args.arch} "
          f"({cfg.n_layers}L d={cfg.d_model}) for {args.steps} steps on "
          f"{trainer.device}; injected failure at step 57 (auto-retried); "
          f"checkpoints -> {args.ckpt}")
    trainer.run()
    for m in trainer.metrics_log:
        print(f"step {m['step']:>4}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.3f}  {m['step_time_s']*1e3:.0f} ms")
    first, last = trainer.metrics_log[0], trainer.metrics_log[-1]
    assert last["loss"] < first["loss"], "loss did not improve"
    print(f"\nloss {first['loss']:.3f} -> {last['loss']:.3f} OK; "
          f"resume by re-running with the same --ckpt")


if __name__ == "__main__":
    main()
