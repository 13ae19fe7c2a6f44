"""Training loop with checkpoint/restart and failure replay (the
reference's ``train/trainer.py``).

  * data is generated deterministically from (seed, step)
    (``data.tokens``), so a restart regenerates its batches;
  * a step that raises ``RuntimeError`` is replayed up to ``max_retries``
    times on the SAME state: the step is pure (``lm.make_train_step``
    builds new tensors), and the state is replaced only after it returns;
  * the kernels' own errors (``ops.KernelLaunchError``,
    ``build.KernelBuildError``, ``torch.AcceleratorError``) are not
    replayed: the CUDA context may be unusable after them, so they are
    raised at once, as ``core.resilience`` raises them (the reference
    retries every ``RuntimeError``);
  * restarts resume from the last atomic checkpoint (``checkpoint``);
  * ``FaultInjector`` simulates node failures for tests and examples.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import checkpoint as ckpt_lib
from .optimizer import Optimizer, adamw
from ..core.device import resolve_device
# the kernels' faults, raised at once rather than replayed
from ..core.resilience import _KERNEL_ERRORS
from ..data import tokens as token_data
from ..models import lm, transformer


class FaultInjector:
    """Deterministically raises on configured steps (simulated node loss)."""

    def __init__(self, fail_steps=(), exc=RuntimeError):
        self.fail_steps = set(fail_steps)
        self.exc = exc
        self.tripped = set()

    def check(self, step: int):
        if step in self.fail_steps and step not in self.tripped:
            self.tripped.add(step)
            raise self.exc(f"injected failure at step {step}")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    max_retries: int = 2
    seed: int = 0
    log_every: int = 10


class Trainer:
    """``device`` None means the card (``core.device.resolve_device``)."""

    def __init__(self, model_cfg, tcfg: TrainerConfig,
                 optimizer: Optimizer | None = None,
                 train_step_fn: Callable | None = None,
                 fault_injector: FaultInjector | None = None, device=None):
        self.cfg = model_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.optimizer = optimizer or adamw(total_steps=tcfg.total_steps)
        self.train_step = train_step_fn or lm.make_train_step(
            model_cfg, self.optimizer, device=self.device)
        self.faults = fault_injector
        self.metrics_log: list[dict] = []

    # ---- state management -------------------------------------------------
    def init_state(self, generator: torch.Generator | None = None):
        """(params, optimizer state, step 0): the parameters drawn from
        ``generator`` (default: seeded with ``tcfg.seed`` on the device)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.tcfg.seed)
        params = transformer.as_tree(
            transformer.init_params(self.cfg, generator))
        return (params, self.optimizer.init(params),
                torch.zeros((), dtype=torch.int32, device=self.device))

    def maybe_restore(self, state):
        """-> (state, the step to run next): the latest checkpoint of
        ``tcfg.ckpt_dir`` where there is one, else ``state`` and 0."""
        d = self.tcfg.ckpt_dir
        if not d:
            return state, 0
        step = ckpt_lib.latest_step(d)
        if step is None:
            return state, 0
        state, extra = ckpt_lib.restore(d, step, state)
        return state, int(extra.get("next_step", step))

    # ---- data -------------------------------------------------------------
    def batch_for(self, step: int):
        toks, labels = token_data.batch_for_step(
            step, global_batch=self.tcfg.global_batch,
            seq_len=self.tcfg.seq_len, vocab_size=self.cfg.vocab_size,
            seed=self.tcfg.seed)
        labels = torch.from_numpy(labels % self.cfg.vocab_size)
        if self.cfg.input_kind == "embeds":
            # modality-stub training: deterministic pseudo-embeddings
            rng = np.random.default_rng(step + self.tcfg.seed)
            emb = rng.standard_normal(
                (self.tcfg.global_batch, self.tcfg.seq_len,
                 self.cfg.d_model)).astype(np.float32) * 0.02
            return {"embeds": torch.from_numpy(emb).to(
                        self.device).to(torch.bfloat16),
                    "labels": labels.to(self.device)}
        return {"tokens": torch.from_numpy(
                    toks % self.cfg.vocab_size).to(self.device),
                "labels": labels.to(self.device)}

    # ---- loop -------------------------------------------------------------
    def run(self, state=None) -> tuple:
        state = state if state is not None else self.init_state()
        state, start = self.maybe_restore(state)
        for step in range(start, self.tcfg.total_steps):
            batch = self.batch_for(step)
            for attempt in range(self.tcfg.max_retries + 1):
                try:
                    if self.faults is not None:
                        self.faults.check(step)
                    t0 = time.perf_counter()
                    new_state, metrics = self.train_step(state, batch)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    dt = time.perf_counter() - t0
                    break
                except _KERNEL_ERRORS:
                    raise
                except RuntimeError:
                    if attempt >= self.tcfg.max_retries:
                        raise
                    continue  # replay the same (pure) step
            state = new_state
            if (step % self.tcfg.log_every == 0
                    or step == self.tcfg.total_steps - 1):
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(step=step, step_time_s=dt)
                self.metrics_log.append(rec)
            if (self.tcfg.ckpt_dir and self.tcfg.ckpt_every
                    and (step + 1) % self.tcfg.ckpt_every == 0):
                ckpt_lib.save(self.tcfg.ckpt_dir, step + 1, state,
                              extra={"next_step": step + 1})
        if self.tcfg.ckpt_dir:
            ckpt_lib.save(self.tcfg.ckpt_dir, self.tcfg.total_steps, state,
                          extra={"next_step": self.tcfg.total_steps})
        return state
