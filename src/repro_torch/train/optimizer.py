"""AdamW with global-norm clipping, Adafactor and a cosine schedule, as
pure functions over nested dicts of float32 tensors (the reference's
``train/optimizer.py``).

``update(grads, state, params, step)`` returns new tensors: the updates
(applied by the caller as ``p + u``) and the new state.  Nothing is
written in place, so a step that fails part way leaves its inputs as they
were and can be replayed (``train.trainer``).  ``torch.optim``'s classes
update in place and are not used.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..core.tree import leaves, tree_map


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """step -> learning rate (a float32 0-d tensor): linear warm-up over
    ``warmup`` steps, then a cosine decay to 0 at ``total``."""
    def lr(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)
    return lr


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    global_norm: Callable


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves(tree)))


def adafactor(lr=1e-2, decay_pow=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0, warmup=100,
              total_steps=10_000) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018), momentum-free, factored 2nd moment.

    State leaves per param: (vr, vc): a matrix (``p.ndim >= 2``) keeps its
    second moment's row and column means, O(rows + cols); a vector keeps
    it whole in ``vr`` and ``vc`` is a scalar dummy."""
    sched = cosine_schedule(lr, warmup, total_steps)

    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def per(p):
            if _factored(p):
                return {"vr": p.new_zeros(p.shape[:-1], dtype=torch.float32),
                        "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32)}
            return {"vr": torch.zeros_like(p, dtype=torch.float32),
                    "vc": p.new_zeros((), dtype=torch.float32)}
        return _per_param(per, params)

    def update(grads, state, params, step):
        t = torch.as_tensor(step).to(torch.float32) + 1
        beta2 = 1.0 - t ** (-decay_pow)
        lr_t = sched(step)

        def per(p, g, st):
            g = g.float()
            g2 = torch.square(g) + eps
            if _factored(p):
                vr = beta2 * st["vr"] + (1 - beta2) * g2.mean(-1)
                vc = beta2 * st["vc"] + (1 - beta2) * g2.mean(-2)
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :]
                    / torch.clamp_min(vr.mean(-1, keepdim=True),
                                      eps)[..., None])
                u = g / torch.clamp_min(denom, eps)
                new_st = {"vr": vr, "vc": vc}
            else:
                vr = beta2 * st["vr"] + (1 - beta2) * g2
                u = g / torch.sqrt(vr + eps)
                new_st = {"vr": vr, "vc": st["vc"]}
            rms_u = torch.sqrt(torch.square(u).mean() + eps)
            u = u / torch.clamp_min(rms_u / clip_threshold, 1.0)
            upd = -lr_t * u - lr_t * weight_decay * p
            return upd.to(p.dtype), new_st

        both = _per_param(per, params, grads, state)
        return (_per_param(lambda pair: pair[0], both, leaf=tuple),
                _per_param(lambda pair: pair[1], both, leaf=tuple))

    return Optimizer(init=init, update=update, global_norm=global_norm)


def _per_param(fn, params, *trees, leaf=torch.Tensor):
    """``fn(p, *matching nodes of trees)`` at each param leaf of the nested
    dict ``params`` (a tree of ``trees`` may hold a dict, Adafactor's
    (vr, vc), where ``params`` holds a tensor)."""
    if isinstance(params, dict):
        return {k: _per_param(fn, params[k], *(t[k] for t in trees),
                              leaf=leaf) for k in params}
    if not isinstance(params, leaf):
        raise TypeError(f"not a parameter tree leaf: {type(params)}")
    return fn(params, *trees)


def adafactor_state_specs(pspecs):
    """Partition specs of Adafactor's state given the param spec tree
    (``transformer.param_specs``): a param's ``vr`` drops its spec's last
    dim, ``vc`` its second last; a vector keeps its spec in ``vr`` and
    its scalar ``vc`` is replicated."""
    from ..models.layers import P

    def per(s):
        s = tuple(s)
        vr = P(*s[:-1]) if len(s) >= 2 else P(*s)
        vc = P(*(s[:-2] + s[-1:])) if len(s) >= 2 else P()
        return {"vr": vr, "vc": vc}

    return _per_param(per, pspecs, leaf=P)


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          clip_norm=1.0, warmup=100, total_steps=10_000) -> Optimizer:
    sched = cosine_schedule(lr, warmup, total_steps)

    def init(params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, step):
        gnorm = global_norm(grads)
        scale = torch.clamp_max(clip_norm / (gnorm + 1e-9), 1.0)
        grads = tree_map(lambda g: g * scale, grads)
        m = tree_map(lambda mu, g: b1 * mu + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda nu, g: b2 * nu + (1 - b2) * torch.square(g),
                     state["v"], grads)
        t = torch.as_tensor(step).to(torch.float32) + 1
        mhat_s = 1.0 / (1 - b1 ** t)
        vhat_s = 1.0 / (1 - b2 ** t)
        lr_t = sched(step)
        updates = tree_map(
            lambda mu, nu, p: -lr_t * (mu * mhat_s /
                                       (torch.sqrt(nu * vhat_s) + eps)
                                       + weight_decay * p),
            m, v, params)
        return updates, {"m": m, "v": v}

    return Optimizer(init=init, update=update, global_norm=global_norm)
