"""Train step, counterpart of ``repro.train.train_step`` on its non-pipeline
path: mixed precision (compute-dtype ``params`` for the forward and
backward, float32 ``master`` weights and moments), optional gradient
accumulation over microbatches, an optional ``grad_transform`` hook.

The gradient is taken with respect to the compute-dtype params and cast to
float32 for the update, as the reference does; under gradient accumulation
the microbatch gradients are summed in float32 and averaged.  The step
consumes the state it is given, as the JAX loop donates it: master and
moments are updated in place and each compute-dtype leaf is replaced as its
update lands, so a caller that takes two steps from one state copies it
first (:func:`copy_state`).  A MegaScope ``collector`` rides the loss, as
in the reference; its captures leave in the step's metrics, on the device.
The pipeline path (``plan.pp > 1``) and int8 gradient compression are
later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.hooks import NULL_COLLECTOR, Collector
from repro_torch.models.model import get_model
from repro_torch.train.optim import (
    OptimizerConfig,
    adamw_update,
    init_opt_state,
    leaves,
    parent,
    tree_map,
)


@dataclass
class TrainState:
    params: dict   # compute-dtype copy used by forward and backward
    master: dict   # float32 master copy
    opt: dict      # {"m", "v"} float32 moments, "step" int


def compute_params(master: dict, dtype: torch.dtype) -> dict:
    """A fresh compute-dtype copy of ``master`` whose leaves take gradients."""
    with torch.no_grad():
        return tree_map(
            lambda x: x.to(dtype, copy=True).requires_grad_(True), master)


def copy_state(state: TrainState) -> TrainState:
    """An independent copy: a step consumes the state it is given."""
    with torch.no_grad():
        clone = lambda x: x.detach().clone().requires_grad_(x.requires_grad)  # noqa: E731
        return TrainState(params=tree_map(clone, state.params),
                          master=tree_map(clone, state.master),
                          opt={"m": tree_map(clone, state.opt["m"]),
                               "v": tree_map(clone, state.opt["v"]),
                               "step": state.opt["step"]})


def init_train_state(cfg: ModelConfig, *, seed: int = 0,
                     device: str | torch.device = "cuda") -> TrainState:
    master = get_model(cfg).init(cfg, seed=seed, device=device)
    params = compute_params(master, getattr(torch, cfg.compute_dtype))
    return TrainState(params=params, master=master, opt=init_opt_state(master))


def to_device_batch(batch: dict, device: torch.device) -> dict:
    """Numpy (or tensor) batch leaves as tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def make_train_step(
    cfg: ModelConfig,
    ocfg: OptimizerConfig,
    *,
    grad_accum: int = 1,
    grad_transform: Callable[[Any], Any] | None = None,
    collector: Collector = NULL_COLLECTOR,
    plan=None,
    compressor=None,
    plain: bool = False,
) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``tokens``, ``targets`` and optionally ``loss_mask``
    (numpy or tensors).  The step updates ``state`` in place and returns
    it.  ``metrics`` holds the last microbatch's loss metrics (as the
    reference's scan keeps them) plus ``grad_norm`` and ``lr``, as 0-dim
    tensors, and the ``collector``'s ``captures`` when it captured any.
    ``plain=True`` runs the plain PyTorch versions of the kernels on any
    device.
    """
    if plan is not None and plan.pp > 1:
        raise NotImplementedError(
            "pipeline-parallel training (plan.pp > 1) is ported with MegaDPP "
            "(ROADMAP queue 1, item 8)")
    if compressor is not None:
        raise NotImplementedError(
            "int8 gradient compression is ported with MegaFT (ROADMAP queue "
            "1, item 9)")
    if plan is not None:
        grad_accum = max(grad_accum, plan.n_micro)
    model = get_model(cfg)
    dtype = getattr(torch, cfg.compute_dtype)

    def grads_of(params: dict, batch: dict):
        loss, metrics = model.loss_fn(cfg, params, batch, collector, plain=plain)
        paths, flat = zip(*leaves(params))
        gflat = torch.autograd.grad(loss, flat)
        grads: dict = {}
        for path, g in zip(paths, gflat):
            node = grads
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = g
        return loss.detach(), tree_map(torch.Tensor.detach, metrics), grads

    def compute_grads(params: dict, batch: dict):
        if grad_accum <= 1:
            return grads_of(params, batch)
        B = batch["targets"].shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} not divisible by grad_accum={grad_accum}")
        mb = B // grad_accum
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=batch["targets"].device)
        metrics = {}
        for i in range(grad_accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, metrics, grads = grads_of(params, micro)
            acc = tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
        return (loss_sum / grad_accum, metrics,
                tree_map(lambda g: g / grad_accum, acc))

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        dev = next(iter(leaves(state.master)))[1].device
        batch = to_device_batch(batch, dev)
        _, metrics, grads = compute_grads(state.params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)

        def refresh(path, master_leaf):
            parent(state.params, path)[path[-1]] = (
                master_leaf.to(dtype, copy=True).requires_grad_(True))

        stats = adamw_update(ocfg, grads, state.master, state.opt, on_leaf=refresh)
        return state, {**metrics, **stats}

    return step

