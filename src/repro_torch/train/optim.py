"""Optimizer, counterpart of ``repro.train.optim``: AdamW with warmup-cosine,
WSD (warmup-stable-decay) and constant schedules, global-norm clipping and
the reference's weight-decay mask.

Trees are the parameters' nested dicts; leaves are visited in sorted key
order, as ``jax.tree.leaves`` visits them, so sums over leaves add in the
same order.  The learning rate is float32 arithmetic on the host (numpy),
as the JAX function computes it in float32; everything else runs on the
tensors' device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Literal

import numpy as np
import torch

_f = np.float32


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: Literal["cosine", "wsd", "constant"] = "cosine"
    warmup_steps: int = 100
    total_steps: int = 10000
    wsd_decay_frac: float = 0.1  # final fraction of steps spent decaying


def schedule_lr(ocfg: OptimizerConfig, step: int) -> np.float32:
    s = _f(step)
    warm = min(s / _f(max(ocfg.warmup_steps, 1)), _f(1.0))
    lo = _f(ocfg.min_lr_frac)
    if ocfg.schedule == "constant":
        frac = _f(1.0)
    elif ocfg.schedule == "cosine":
        span = _f(max(ocfg.total_steps - ocfg.warmup_steps, 1))
        t = np.clip((s - _f(ocfg.warmup_steps)) / span, _f(0.0), _f(1.0))
        frac = lo + (_f(1) - lo) * _f(0.5) * (_f(1) + np.cos(_f(math.pi) * t))
    elif ocfg.schedule == "wsd":
        # warmup -> stable plateau -> linear decay tail
        decay_steps = int(ocfg.total_steps * ocfg.wsd_decay_frac)
        decay_start = ocfg.total_steps - decay_steps
        t = np.clip((s - _f(decay_start)) / _f(max(decay_steps, 1)),
                    _f(0.0), _f(1.0))
        frac = _f(1.0) - (_f(1.0) - lo) * t
    else:
        raise ValueError(ocfg.schedule)
    return _f(ocfg.lr) * warm * frac


def leaves(tree: dict) -> Iterator[tuple[tuple[str, ...], torch.Tensor]]:
    """``(path, leaf)`` in ``jax.tree.leaves`` order (sorted keys)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            for path, leaf in leaves(v):
                yield (k, *path), leaf
        else:
            yield (k,), v


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def _decay_mask(params: dict) -> dict:
    """1.0 where weight decay applies: every leaf with ``ndim >= 2``, as the
    reference decides it.  Layer-stacked leaves carry a leading layer axis,
    so stacked norm scales and biases are decayed and ``final_norm.scale``
    is not (ROADMAP R1)."""
    return tree_map(lambda p: float(p.dim() >= 2), params)


def init_opt_state(master: dict) -> dict:
    return {"m": tree_map(torch.zeros_like, master),
            "v": tree_map(torch.zeros_like, master), "step": 0}


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum((g.float() * g.float()).sum() for _, g in leaves(tree)))


@torch.no_grad()
def adamw_update(ocfg: OptimizerConfig, grads: dict, master: dict, opt: dict
                 ) -> tuple[dict, dict, dict]:
    """Returns ``(new_master, new_opt_state, stats)``; grads are float32 and
    shaped like ``master``."""
    step = opt["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(ocfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = ocfg.betas
    lr = schedule_lr(ocfg, step)
    bc1 = _f(1) - _f(b1) ** _f(step)
    bc2 = _f(1) - _f(b2) ** _f(step)
    mask = _decay_mask(master)

    def upd(g, p, m, v, wd):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * (g * g)
        mhat = m / float(bc1)
        vhat = v / float(bc2)
        delta = mhat / (torch.sqrt(vhat) + ocfg.eps) + ocfg.weight_decay * wd * p
        return p - float(lr) * delta, m, v

    out = tree_map(upd, grads, master, opt["m"], opt["v"], mask)
    pick = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731
    stats = {"grad_norm": gnorm,
             "lr": torch.tensor(lr, dtype=torch.float32, device=gnorm.device)}
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, stats
