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
from typing import Callable, Iterator, Literal

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


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    sq = g.to(torch.float32, copy=True)
    return sq.mul_(sq).sum()


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the float32 sums of squares, leaf by leaf in ``leaves`` order;
    one leaf's float32 copy at a time."""
    return torch.sqrt(sum(_square_sum(g) for _, g in leaves(tree)))


def parent(tree: dict, path: tuple[str, ...]) -> dict:
    """The dict that holds the leaf at ``path``."""
    for key in path[:-1]:
        tree = tree[key]
    return tree


@torch.no_grad()
def adamw_update(ocfg: OptimizerConfig, grads: dict, master: dict, opt: dict,
                 on_leaf: Callable[[tuple[str, ...], torch.Tensor], None] | None = None
                 ) -> dict:
    """AdamW in place, leaf by leaf; returns ``stats``.

    ``master``, ``opt["m"]`` and ``opt["v"]`` are updated in place and
    ``opt["step"]`` advanced, with the reference's arithmetic in its order
    (``repro.train.optim.adamw_update``).  ``grads`` (shaped like
    ``master``, any float dtype) is consumed: each leaf is cast to float32
    inside its own update and dropped from the tree once applied, so at
    most a few float32 temporaries of one leaf exist at a time; the JAX
    step gets the same effect by donating the state.  ``on_leaf(path,
    master_leaf)`` runs after each leaf's update."""
    step = opt["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(ocfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = ocfg.betas
    lr = schedule_lr(ocfg, step)
    bc1 = _f(1) - _f(b1) ** _f(step)
    bc2 = _f(1) - _f(b2) ** _f(step)
    mask = dict(leaves(_decay_mask(master)))

    for path, p in list(leaves(master)):
        g = parent(grads, path).pop(path[-1]).to(torch.float32, copy=True).mul_(scale)
        m, v = parent(opt["m"], path)[path[-1]], parent(opt["v"], path)[path[-1]]
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.mul_(g).mul_(1 - b2))
        del g
        delta = m / float(bc1)                                  # mhat
        delta.div_((v / float(bc2)).sqrt_().add_(ocfg.eps))     # / (sqrt(vhat) + eps)
        delta.add_(p * (ocfg.weight_decay * mask[path]))
        p.sub_(delta.mul_(float(lr)))
        del delta
        if on_leaf is not None:
            on_leaf(path, p)
    opt["step"] = step
    return {"grad_norm": gnorm,
            "lr": torch.tensor(lr, dtype=torch.float32, device=gnorm.device)}
