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

With a :class:`repro_torch.parallel.plan.ParallelPlan` whose ``pp > 1`` the
step routes the block stack through MegaDPP's schedule-controlled pipeline
executor (``core.dpp.executor``) instead of the fused forward: the
microbatched traversal is the pipeline's, and the backward is autograd's
mirror of it.  ``plan.fbd_backward`` attaches MegaFBD's decoupled backward
(``core.fbd.decouple``: a forward instance that hands its residuals to a
backward instance).  At ``pp == 1`` a plan is plain gradient accumulation
over ``plan.n_micro`` microbatches, bit for bit the plain step.  int8
gradient compression is a later slice.
"""

from __future__ import annotations

import logging
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


def unused_leaves(cfg: ModelConfig) -> tuple[tuple[str, ...], ...]:
    """The leaves the loss of ``cfg`` does not reach: an embeds arch
    (qwen2-vl) takes its inputs as embeddings, so its untied ``embedding``
    table is unused.  The encoder-decoder's decoder takes tokens: every
    leaf of it reaches the loss."""
    if (cfg.input_kind != "tokens" and cfg.family != "encdec"
            and not cfg.tie_embeddings):
        return (("embedding",),)
    return ()


def grad_tree(params: dict, loss: torch.Tensor,
              unused: tuple[tuple[str, ...], ...] = ()) -> dict:
    """``torch.autograd.grad`` of ``loss`` for every leaf, in ``params``'
    tree.  A leaf in ``unused`` (:func:`unused_leaves`) the loss does not
    reach gets zeros, as ``jax.grad`` gives it; any other such leaf
    raises."""
    paths, flat = zip(*leaves(params))
    grads: dict = {}
    for path, leaf, g in zip(paths, flat, torch.autograd.grad(
            loss, flat, allow_unused=bool(unused))):
        if g is None:
            if path not in unused:
                raise RuntimeError(f"leaf {'/'.join(path)} does not reach the loss")
            g = torch.zeros_like(leaf)
        node = grads
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = g
    return grads


def _accumulate(grads_once: Callable, grad_accum: int) -> Callable:
    """``compute_grads(params, batch)``: ``grads_once`` over ``grad_accum``
    equal slices of the batch (on axis 1 of the ``[3, B, S]`` M-RoPE ids,
    axis 0 of every other leaf), the float32 gradients summed and averaged,
    the loss averaged and the last slice's metrics kept (as the reference's
    scan keeps them)."""
    if grad_accum <= 1:
        return grads_once

    def compute_grads(params: dict, batch: dict):
        B = batch["targets"].shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} not divisible by grad_accum={grad_accum}")
        mb = B // grad_accum
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=batch["targets"].device)
        metrics = {}
        for i in range(grad_accum):
            sl = slice(i * mb, (i + 1) * mb)
            micro = {k: v[:, sl] if k == "mrope_position_ids" else v[sl]
                     for k, v in batch.items()}
            loss, metrics, grads = grads_once(params, micro)
            acc = tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
        return (loss_sum / grad_accum, metrics,
                tree_map(lambda g: g / grad_accum, acc))

    return compute_grads


def _updater(cfg: ModelConfig, ocfg: OptimizerConfig, compute_grads: Callable,
             grad_transform: Callable | None) -> Callable:
    """``step(state, batch)``: the gradients of ``compute_grads``, then
    AdamW on the float32 master, refreshing each compute-dtype leaf as its
    update lands."""
    dtype = getattr(torch, cfg.compute_dtype)

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


@dataclass(frozen=True)
class PipelineStepInfo:
    """Static pipeline context attached to a pp > 1 step callable
    (``.pipeline``), so the train loop can emit MegaScan's per-(microbatch,
    stage, F/B) events each step and count the pipelined step's products.
    ``loss_fn(params, batch) -> (loss, metrics)`` is the pipelined loss the
    step differentiates."""

    plan: Any            # ParallelPlan
    table: Any           # core.dpp.executor.TimeTable
    layout: Any          # models.pipeline.PipelineLayout
    loss_fn: Callable


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

    ``batch`` holds ``tokens`` (or an embeds arch's ``embeds`` and
    ``mrope_position_ids``), ``targets`` and optionally ``loss_mask``
    (numpy or tensors).  The step updates ``state`` in place and returns
    it.  ``metrics`` holds the last microbatch's loss metrics (as the
    reference's scan keeps them) plus ``grad_norm`` and ``lr``, as 0-dim
    tensors, and the ``collector``'s ``captures`` when it captured any.
    ``plain=True`` runs the plain PyTorch versions of the kernels on any
    device.
    """
    if compressor is not None:
        raise NotImplementedError(
            "int8 gradient compression is ported with MegaFT (ROADMAP queue "
            "1, item 9)")
    if plan is not None and plan.pp > 1:
        return _make_pipeline_train_step(
            cfg, ocfg, plan, grad_accum=grad_accum,
            grad_transform=grad_transform, collector=collector, plain=plain)
    if plan is not None:
        grad_accum = max(grad_accum, plan.n_micro)
    model = get_model(cfg)
    unused = unused_leaves(cfg)

    def grads_of(params: dict, batch: dict):
        loss, metrics = model.loss_fn(cfg, params, batch, collector, plain=plain)
        return (loss.detach(), tree_map(torch.Tensor.detach, metrics),
                grad_tree(params, loss, unused))

    return _updater(cfg, ocfg, _accumulate(grads_of, grad_accum), grad_transform)


def _make_pipeline_train_step(
    cfg: ModelConfig,
    ocfg: OptimizerConfig,
    plan,
    *,
    grad_accum: int = 1,
    grad_transform: Callable[[Any], Any] | None = None,
    collector: Collector = NULL_COLLECTOR,
    plain: bool = False,
) -> Callable:
    """The pp > 1 train step: the block stack through the MegaDPP pipeline
    executor, every stage on the device of the state it is given
    (``make_pipeline_stages``).

    Params stay in their canonical stacked layout (the restack to ``[stage,
    chunk, ...]`` is a view taken inside the loss), so the optimizer update
    and the checkpoint format are the fused path's.  ``grad_accum > 1`` runs
    that many full pipeline passes back to back and averages their
    gradients: macrobatch accumulation on top of the microbatched
    traversal.  With ``plan.fbd_backward`` the gradients come from
    ``make_decoupled_step``'s ``fwd`` then ``bwd`` through the residuals
    (the counterpart of JAX's ``jax.vjp`` + ``closure_convert``): the same
    graph, so the same bits as the fused pipelined step.
    """
    from repro_torch.core.dpp.executor import build_time_table, make_pipeline_stages
    from repro_torch.core.fbd.decouple import make_decoupled_step
    from repro_torch.models import pipeline as pl
    from repro_torch.parallel.plan import forward_order

    if plan.dp > 1 or plan.tp > 1:
        raise NotImplementedError(
            f"the pipeline train step runs dp = tp = 1 (got dp={plan.dp}, "
            f"tp={plan.tp}); data and tensor parallelism are ported in a "
            "later slice (ROADMAP queue 1, item 8b)")
    layout = pl.pipeline_layout(cfg, plan.pp, plan.n_chunks, tp=plan.tp)
    table = build_time_table(
        forward_order(plan), plan.pp, plan.n_chunks, plan.n_micro_local)
    block_fn = pl.make_block_fn(cfg, layout, plain=plain)
    if collector is not NULL_COLLECTOR:
        logging.getLogger("repro_torch.train").warning(
            "MegaScope probes do not observe pipelined blocks (pp=%d): "
            "captures cannot ride the pipeline's activation wire", plan.pp)

    def loss_of(params: dict, batch: dict):
        stages = make_pipeline_stages(plan.pp, batch["targets"].device)
        return pl.pipeline_loss(cfg, params, batch, layout=layout, table=table,
                                stages=stages, n_micro=plan.n_micro,
                                block_fn=block_fn, plain=plain)

    if plan.fbd_backward:
        decoupled = make_decoupled_step(lambda p, b: loss_of(p, b)[0])

        def grads_once(params: dict, batch: dict):
            # MegaFBD attach: the forward instance records the residuals,
            # the backward instance consumes them (the F->B transfer
            # MegaFBD's coordinator manages)
            loss, residuals = decoupled.fwd(params, batch)
            grads = decoupled.bwd(params, batch, residuals, torch.ones_like(loss))
            aux = torch.zeros((), dtype=torch.float32, device=loss.device)
            return loss, {"loss": loss, "ce": loss, "aux_loss": aux}, grads
    else:
        def grads_once(params: dict, batch: dict):
            loss, metrics = loss_of(params, batch)
            return (loss.detach(), tree_map(torch.Tensor.detach, metrics),
                    grad_tree(params, loss))

    step = _updater(cfg, ocfg, _accumulate(grads_once, grad_accum), grad_transform)
    step.pipeline = PipelineStepInfo(plan=plan, table=table, layout=layout,
                                     loss_fn=loss_of)
    return step

