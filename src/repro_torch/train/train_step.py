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
backward instance).  A plan with dp or tp > 1, or given a mesh, runs on
one rank of a world (:func:`_make_world_train_step`): the batch split
over ``data``, Megatron's tensor split over ``model``, each stage a
process.  At ``pp == 1`` without a mesh a plan is plain gradient
accumulation over ``plan.n_micro`` microbatches, bit for bit the plain
step.  A ``compressor`` (MegaFT's int8 gradient sync with error feedback)
quantize-dequantizes the whole gradient just before AdamW.
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
    global_norm,
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
             grad_transform: Callable | None, *, sync: Callable | None = None,
             norm: Callable = global_norm, compressor=None) -> Callable:
    """``step(state, batch)``: the gradients of ``compute_grads``, then
    AdamW on the float32 master, refreshing each compute-dtype leaf as its
    update lands.  In a world, ``sync(metrics, grads) -> (metrics, grads)``
    sums the ranks' shares of the gradients and of the (last accumulation
    slice's) loss and its terms first, and ``norm`` is the whole model's.  With a
    ``compressor`` the step is ``step(state, err, batch) -> (state, err,
    metrics)``: the whole gradient (summed, in a world) is
    quantize-dequantized in its own dtype, just before AdamW's float32
    cast, and the residual carried in the error buffers ``err``."""
    dtype = getattr(torch, cfg.compute_dtype)

    def update(state: TrainState, err, batch: dict):
        dev = next(iter(leaves(state.master)))[1].device
        batch = to_device_batch(batch, dev)
        _, metrics, grads = compute_grads(state.params, batch)
        if sync is not None:
            metrics, grads = sync(metrics, grads)
        if grad_transform is not None:
            grads = grad_transform(grads)
        if compressor is not None:
            grads, err = compressor.apply(grads, err)

        def refresh(path, master_leaf):
            parent(state.params, path)[path[-1]] = (
                master_leaf.to(dtype, copy=True).requires_grad_(True))

        stats = adamw_update(ocfg, grads, state.master, state.opt, on_leaf=refresh,
                             norm=norm)
        return state, err, {**metrics, **stats}

    if compressor is not None:
        return update

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        state, _, metrics = update(state, None, batch)
        return state, metrics

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
    mesh=None,
    compressor=None,
    plain: bool = False,
) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``, or with a
    ``compressor`` (a ``repro_torch.ft.GradCompressor``: int8 gradient sync
    with error feedback, the ft controller's mitigation of a degraded data
    link) ``step(state, err, batch) -> (state, err, metrics)``, ``err`` the
    float32 error buffers (``compressor.init(state.master)``); the
    ``TrainState`` and so the checkpoint format are unchanged.  A pp > 1
    plan with dp = 1 has no data axis to compress over and raises, as in
    JAX; in a world, compression runs at pp = tp = 1 (ROADMAP item 8c).

    A ``plan`` with dp or tp > 1, or any plan given a ``mesh`` (default: the
    one ``parallel.sharding.axis_rules`` installed), runs in the world of
    the mesh's ranks (:func:`_make_world_train_step`); the mesh must be
    shaped ``{"stage": pp, "data": dp, "model": tp}``
    (``launch.mesh.make_pipeline_mesh``).  Without one, a pp > 1 plan runs
    every stage in this process.

    ``batch`` holds ``tokens`` (or an embeds arch's ``embeds`` and
    ``mrope_position_ids``), ``targets`` and optionally ``loss_mask``
    (numpy or tensors).  The step updates ``state`` in place and returns
    it.  ``metrics`` holds the last microbatch's loss metrics (as the
    reference's scan keeps them) plus ``grad_norm`` and ``lr``, as 0-dim
    tensors, and the ``collector``'s ``captures`` when it captured any.
    ``plain=True`` runs the plain PyTorch versions of the kernels on any
    device.
    """
    if compressor is not None and plan is not None and plan.pp > 1 and plan.dp <= 1:
        raise ValueError(
            "gradient compression targets the DP gradient sync; a "
            f"pp={plan.pp} plan with dp=1 has no data axis to compress "
            "over — set parallel.dp > 1 to compose them"
        )
    if mesh is None:
        from repro_torch.parallel.sharding import current_mesh_and_rules

        mesh = current_mesh_and_rules()[0]
    if plan is not None and (plan.dp > 1 or plan.tp > 1 or mesh is not None):
        from repro_torch.launch.mesh import mesh_axes

        want = {"stage": plan.pp, "data": plan.dp, "model": plan.tp}
        have = mesh_axes(mesh)
        if mesh is None or any(have.get(ax, 1) != n for ax, n in want.items()):
            raise ValueError(
                f"pipeline train step (pp={plan.pp}, dp={plan.dp}, "
                f"tp={plan.tp}) needs a mesh shaped {want}; got "
                f"{have or None} — build one with "
                "repro_torch.launch.mesh.make_pipeline_mesh(pp, dp, tp)"
            )
        return _make_world_train_step(
            cfg, ocfg, plan, mesh, grad_accum=grad_accum,
            grad_transform=grad_transform, collector=collector, plain=plain,
            compressor=compressor)
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

    return _updater(cfg, ocfg, _accumulate(grads_of, grad_accum), grad_transform,
                    compressor=compressor)


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
    """The pp > 1 train step in one process: the block stack through the
    MegaDPP pipeline executor, every stage on the device of the state it
    is given (``make_pipeline_stages``).

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

    layout = pl.pipeline_layout(cfg, plan.pp, plan.n_chunks)
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



# ------------------------------------------------------- in a world of ranks


@dataclass(frozen=True)
class ParallelStepInfo:
    """Static context of a step that runs in a world of ranks (attached as
    ``.parallel``): the plan, the mesh, this rank's ``coords`` (``stage``,
    ``data``, ``model``) and the stage and tensor split's ``layout`` (None
    at pp = tp = 1).  A rank owns its part of the state (:func:`own_part`):
    ``local_state(master)`` builds it from the whole float32 master (every
    rank draws the same one), ``shard_state(state)`` cuts it from a whole
    :class:`TrainState` (a restored checkpoint), and ``gather_state(state)``,
    called on every rank, puts the whole state back together on rank 0
    (None on the others); ``gather(tree)`` does so for one tree of parts
    (parameters, gradients)."""

    plan: Any
    mesh: Any
    coords: dict
    layout: Any
    local_state: Callable
    shard_state: Callable
    gather_state: Callable
    gather: Callable


def _rows(batch: dict, i: int, n: int) -> dict:
    """The ``i``-th of ``n`` contiguous row blocks of ``batch`` (axis 1 of
    the ``[3, B, S]`` M-RoPE ids, axis 0 of every other leaf)."""
    if n == 1:
        return batch
    B = batch["targets"].shape[0]
    if B % n:
        raise ValueError(f"batch {B} not divisible by dp={n}")
    sl = slice(i * (B // n), (i + 1) * (B // n))
    return {k: v[:, sl] if k == "mrope_position_ids" else v[sl]
            for k, v in batch.items()}


def _count(batch: dict) -> torch.Tensor:
    """The loss's token count: the mask's sum, or every target."""
    m = batch.get("loss_mask")
    if m is None:
        return torch.tensor(float(batch["targets"].numel()),
                            device=batch["targets"].device)
    return m.float().sum()


def _share(local: dict, whole: dict) -> torch.Tensor:
    """The weight of a rank's mean loss over ``local`` rows in the mean
    over ``whole``: its share of the mask count (a masked mean divides by
    ``max(count, 1)``), so the data ranks' weighted gradients sum to the
    whole batch's whatever the masks."""
    return (torch.clamp(_count(local), min=1.0) / torch.clamp(_count(whole), min=1.0))


def own_part(tree: dict, layout, coords: dict, dims: dict, tp: int) -> dict:
    """The part of a whole tree the rank at ``coords`` owns: its stage's
    (``models.pipeline.stage_part``: the segment's groups of its cells, and
    on stage 0 the embedding and the head), cut to its tensor slice
    (``weights.shard_params`` of the leaves in ``dims``).  The whole tree at
    pp = tp = 1."""
    from repro_torch.models.pipeline import stage_part
    from repro_torch.models.weights import shard_params

    if layout is not None:
        tree = stage_part(tree, layout, coords["stage"])
    if tp > 1:
        tree = shard_params(tree, dims, tp, coords["model"])
    return tree


def _gather_parts(tree: dict, layout, mesh, coords: dict, dims: dict,
                  tp: int) -> dict | None:
    """The whole tree on rank 0 from the parts of the ranks of data
    coordinate 0 (the others hold copies of them): each (stage, model)
    rank sends rank 0 the leaves of its part no other rank holds (a
    stage's segment; at pp = 1 its tensor slices), and rank 0's own part
    gives their shapes (every such part has the same); None off rank 0."""
    from repro_torch.models.pipeline import merge_stages
    from repro_torch.models.weights import unshard_params
    from repro_torch.parallel.dist import exchange

    if layout is None and tp == 1:
        return tree if mesh.get_rank() == 0 else None
    if coords["data"]:
        return None
    pp = 1 if layout is None else layout.pp
    names = list(mesh.mesh_dim_names)
    grid = mesh.mesh.movedim(names.index("data"), 0)[0]  # [stage, model]
    own = [(p, t) for p, t in leaves(tree)
           if (p[0] == layout.seg_key if layout is not None else p in dims)]
    if mesh.get_rank() != 0:
        exchange([(t, 0) for _, t in own], [])
        return None
    got = {}
    recvs = []
    for s in range(pp):
        for m in range(tp):
            if (s, m) == (0, 0):
                continue
            got[(s, m)] = [torch.empty_like(t) for _, t in own]
            recvs += [(b, int(grid[s, m])) for b in got[(s, m)]]
    exchange([], recvs)

    def part(s: int, m: int) -> dict:
        if (s, m) == (0, 0):
            return tree
        out = tree_map(lambda t: t, tree)
        if s > 0:  # a later stage holds only its segment
            out = {layout.seg_key: out[layout.seg_key]}
        for (path, _), t in zip(own, got[(s, m)]):
            parent(out, path)[path[-1]] = t
        return out

    slices = [merge_stages([part(s, m) for s in range(pp)], layout)
              if layout is not None else part(0, m) for m in range(tp)]
    return slices[0] if tp == 1 else unshard_params(slices, dims)


def _make_world_train_step(
    cfg: ModelConfig,
    ocfg: OptimizerConfig,
    plan,
    mesh,
    *,
    grad_accum: int = 1,
    grad_transform: Callable[[Any], Any] | None = None,
    collector: Collector = NULL_COLLECTOR,
    plain: bool = False,
    compressor=None,
) -> Callable:
    """The train step of one rank of a (stage, data, model) mesh.

    * ``data``: each rank takes its contiguous ``batch / dp`` rows (JAX's
      ``batch -> ("pod", "data")``; under ``grad_accum`` of each
      accumulation slice) and weighs its cross entropy by its share of the
      mask count (:func:`_share`), so the gradients summed over the data
      ranks are the whole batch's; the loss in the metrics is the global
      one.  Over MoE layers the router's counts are summed over the data
      ranks and each rank's aux loss is its part of the whole batch's
      (``models.split``), not weighed by the share.
    * ``model``: at pp = 1 the family's own forward runs Megatron's split
      over this rank's slices of the weights (``lm.loss_fn`` with a
      ``models.split.Split``: the vocabulary of the embedding and the
      cross entropy, dense GQA blocks, M-RoPE's among them, MLA, MoE with
      its shared experts, RWKV-6 and Griffin blocks, and the
      encoder-decoder's layers).  Inside a pipeline the split runs dense
      GQA blocks only (``models.pipeline.make_block_fn``), and stage 0's
      embedding and head run whole.
    * ``stage``: each stage is a process (``models.pipeline
      .pipeline_ranks_grads``); dp groups each pipeline
      ``plan.n_micro_local`` microbatches; ``plan.fbd_backward`` runs a
      stage's backward on the next stage's process (MegaFBD).

    A rank owns only its part of the parameters, the float32 master and
    the moments (:func:`own_part`: its stage's layers, the embedding and
    the head on stage 0, its tensor slice of each) and updates that part
    alone.  Its gradients are summed over the ``data`` ranks only (one
    flat float32 buffer a dtype); the clip's global norm adds the parts'
    squares over ``model`` (the sliced leaves) and over ``stage``.
    """
    from repro_torch.core.dpp.executor import build_time_table, make_pipeline_stages
    from repro_torch.models import pipeline as pl
    from repro_torch.models.split import make_split, tp_slices
    from repro_torch.parallel import dist as pdist
    from repro_torch.parallel.plan import forward_order

    names = list(mesh.mesh_dim_names)
    coords = {ax: 0 for ax in ("stage", "data", "model")}
    coords.update(zip(names, mesh.get_coordinate()))
    if compressor is not None and (plan.pp > 1 or plan.tp > 1):
        raise NotImplementedError(
            f"int8 gradient compression in a world runs at pp = tp = 1 (this "
            f"plan: pp={plan.pp}, tp={plan.tp}): its 256-element blocks would "
            "span the ranks' parts of a leaf (ROADMAP queue 1, item 8c)")
    group = lambda ax, n: mesh.get_group(ax) if n > 1 else None  # noqa: E731
    data_group = group("data", plan.dp)
    model_group = group("model", plan.tp)
    stage_group = group("stage", plan.pp)
    model = get_model(cfg)
    unused = unused_leaves(cfg)
    split = None
    if plan.tp > 1 or (plan.dp > 1 and cfg.family == "moe"):
        moe_dp = cfg.family == "moe" and plan.dp > 1
        split = make_split(cfg, plan.tp, group=model_group, rank=coords["model"],
                           data_group=data_group if moe_dp else None,
                           dp=plan.dp if moe_dp else 1, pp=plan.pp)
    dims = tp_slices(cfg, plan.tp, plan.pp)
    layout = None
    if plan.pp > 1:
        layout = pl.pipeline_layout(cfg, plan.pp, plan.n_chunks, tp=plan.tp)
        block_fn = pl.make_block_fn(cfg, layout, plain=plain, split=split)
    if collector is not NULL_COLLECTOR and (plan.pp > 1 or plan.tp > 1):
        logging.getLogger("repro_torch.train").warning(
            "MegaScope probes do not observe split or pipelined blocks (pp=%d, "
            "tp=%d): captures cannot ride the activation wire", plan.pp, plan.tp)
        collector = NULL_COLLECTOR

    if plan.pp > 1:
        table = build_time_table(forward_order(plan), plan.pp, plan.n_chunks,
                                 plan.n_micro_local)
        ranks = make_pipeline_stages(plan.pp, mesh=mesh)

        def grads_once(params: dict, batch: dict):
            local = _rows(batch, coords["data"], plan.dp)
            return pl.pipeline_ranks_grads(
                cfg, params, local, layout=layout, table=table, ranks=ranks,
                stage=coords["stage"], n_micro=plan.n_micro_local,
                block_fn=block_fn, weight=_share(local, batch),
                fbd=plan.fbd_backward, plain=plain)
    else:
        def grads_once(params: dict, batch: dict):
            local = _rows(batch, coords["data"], plan.dp)
            kw = {} if split is None else {"split": split}
            _, metrics = model.loss_fn(cfg, params, local, collector, plain=plain, **kw)
            # the cross entropy weighed by this rank's share; an aux loss is
            # already this rank's part of the whole batch's (or the whole
            # one, the same on every tensor rank, at dp = 1)
            ce = metrics["ce"] * _share(local, batch)
            loss = ce + metrics["aux_loss"]
            metrics = {**tree_map(torch.Tensor.detach, metrics), "loss": loss.detach(),
                       "ce": ce.detach()}
            return loss.detach(), metrics, grad_tree(params, loss, unused)

    summed = ("loss", "ce", "aux_loss")

    def sync(metrics, grads):
        # the loss and its terms: the data ranks' shares, held by stage 0;
        # a MoE segment's drop fraction: the mean over the data ranks
        keys = [k for k in metrics if k in summed or k.endswith("_moe_drop_frac")]
        vec = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        for g in (data_group, stage_group):
            if g is not None:
                torch.distributed.all_reduce(vec, group=g)
        metrics = {**metrics, **{k: v if k in summed else v / plan.dp
                                 for k, v in zip(keys, vec)}}
        if data_group is not None:
            grads = pdist.all_reduce_tree(grads, data_group)
        return metrics, grads

    sliced = frozenset(dims)

    def over(g):
        return None if g is None else (lambda x: pdist.all_reduce_scalar(x, g))

    def norm(grads):
        return global_norm(grads, sliced=sliced, reduce=over(model_group),
                           total=over(stage_group))

    step = _updater(cfg, ocfg, _accumulate(grads_once, grad_accum), grad_transform,
                    sync=sync, norm=norm if layout is not None or plan.tp > 1
                    else global_norm, compressor=compressor)
    if plan.pp > 1:
        step.pipeline = PipelineStepInfo(plan=plan, table=table, layout=layout,
                                         loss_fn=None)
    dtype = getattr(torch, cfg.compute_dtype)
    own = lambda tree: own_part(tree, layout, coords, dims, plan.tp)  # noqa: E731

    def local_state(master: dict) -> TrainState:
        master = own(master)
        return TrainState(params=compute_params(master, dtype), master=master,
                          opt=init_opt_state(master))

    def shard_state(state: TrainState) -> TrainState:
        if layout is None and plan.tp == 1:
            return state
        master = own(state.master)
        return TrainState(params=compute_params(master, dtype), master=master,
                          opt={"m": own(state.opt["m"]), "v": own(state.opt["v"]),
                               "step": state.opt["step"]})

    def gather(tree: dict) -> dict | None:
        return _gather_parts(tree, layout, mesh, coords, dims, plan.tp)

    def gather_state(state: TrainState) -> TrainState | None:
        whole = [gather(t) for t in (state.master, state.opt["m"], state.opt["v"])]
        if whole[0] is None:
            return None
        return TrainState(params=compute_params(whole[0], dtype), master=whole[0],
                          opt={"m": whole[1], "v": whole[2], "step": state.opt["step"]})

    step.parallel = ParallelStepInfo(
        plan=plan, mesh=mesh, coords=coords, layout=layout, local_state=local_state,
        shard_state=shard_state, gather_state=gather_state, gather=gather)
    return step
