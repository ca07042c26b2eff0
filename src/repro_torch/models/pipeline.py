"""Stage-stackable block application for MegaDPP pipeline parallelism,
counterpart of ``repro.models.pipeline``.

Bridges the model layer and ``repro_torch.core.dpp.executor``: the LM
families stack their repeating blocks into one ``[layers, ...]`` segment
(``lm.segment_layout``); the pipeline needs those same weights laid out
``[stages, chunks_per_stage, groups_per_cell, ...]`` so the executor can
index cell ``(s, c)``.  Three pieces live here:

* :func:`pipeline_layout` — validates a config is pipeline-stackable and
  derives the (pp, n_chunks, groups-per-cell) split of its layer stack;
* :func:`restack_params` — the ``[G, ...] -> [S, C, G/(S*C), ...]`` view
  of the canonical stacked leaves (chunk-major, matching the executor's
  (c, s) traversal: global group ``(c*S + s)*gpc + j``), so gradients land
  in the canonical layout and the optimizer, checkpoints and
  ``weights.to_jax_params`` are unchanged;
* :func:`make_block_fn` / :func:`pipeline_loss` — the per-cell apply (the
  model's own blocks, ``lm._block``) and the full pipelined loss (embed ->
  ``pipeline_apply`` -> final norm -> chunked cross entropy), which
  ``repro_torch.train.train_step`` differentiates.

Restrictions (raise up front): families whose layer stack is a single
uniform segment only (MoE's aux losses cannot ride the activation wire;
mrope archs need per-block position ids the pipelined apply does not
thread).  With ``tp > 1`` inside the pipeline the blocks run Megatron's
tensor split (:func:`_validate_tp`: dense GQA blocks whose heads, kv heads
and ffn width divide ``tp``) through ``models.split``: each tensor rank
holds its slice of the weights (``weights.shard_params``), runs the block
over its local heads and ffn width, and the conjugate pair of
``parallel.dist`` all-reduces after the attention-out and MLP-down
products (each rank's part of them kept in float32 up to the sum).  At
``pp == 1`` the tensor split needs no layout: the families' own forwards
run it (``lm.loss_fn`` with a split).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dpp.executor import TimeTable, pipeline_apply
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.hooks import NULL_COLLECTOR
from repro_torch.models.split import Split, tp_slices
from repro_torch.train.optim import tree_map


@dataclass(frozen=True)
class PipelineLayout:
    """How one family's stacked layer segment splits across the pipeline."""

    seg_key: str               # params key of the (single) stacked segment
    kinds: tuple[str, ...]     # block kinds inside one group
    n_groups: int              # stacked groups in the segment
    pp: int                    # pipeline stages
    n_chunks: int              # virtual chunks per stage (interleaving)
    groups_per_cell: int       # consecutive groups one (stage, chunk) holds
    tp: int = 1                # tensor degree inside each stage's body


def pipeline_layout(
    cfg: ModelConfig, pp: int, n_chunks: int = 1, tp: int = 1
) -> PipelineLayout:
    """Derive (and validate) the stage/chunk split of ``cfg``'s layer stack."""
    if cfg.family == "moe":
        raise ValueError(
            "pipeline parallelism does not support MoE yet: router aux "
            "losses cannot ride the pipeline's activation wire"
        )
    if cfg.input_kind == "embeds_mrope":
        raise ValueError(
            "pipeline parallelism does not support mrope archs: per-block "
            "mrope position ids are not threaded through the pipelined apply"
        )
    segs = lm.segment_layout(cfg)
    if len(segs) != 1:
        raise ValueError(
            f"{cfg.name}: pipeline parallelism needs a single uniform layer "
            f"segment, got {len(segs)} (layout {segs})"
        )
    kinds, n_groups = segs[0]
    cells = pp * n_chunks
    if n_groups % cells != 0:
        raise ValueError(
            f"{cfg.name}: {n_groups} layer group(s) not divisible by "
            f"pp*n_chunks = {pp}*{n_chunks} = {cells}"
        )
    if tp > 1:
        _validate_tp(cfg, tp)
    return PipelineLayout("seg0", tuple(kinds), n_groups, pp, n_chunks,
                          n_groups // cells, tp)


def _validate_tp(cfg: ModelConfig, tp: int) -> None:
    """tp>1 inside the pipeline is the Megatron split of dense GQA blocks:
    heads / kv-heads / ffn width slice across the ``model`` axis, with an
    explicit all-reduce after the attention-out and mlp-down projections."""
    segs = lm.segment_layout(cfg)
    kinds = set(segs[0][0]) if len(segs) == 1 else {k for ks, _ in segs for k in ks}
    if kinds != {"dense"} or cfg.use_mla:
        raise ValueError(
            f"{cfg.name}: tp={tp} inside the pipeline supports dense GQA "
            f"blocks only (got kinds {sorted(kinds)}"
            f"{', mla' if cfg.use_mla else ''})"
        )
    H, K, F = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    if H % tp or K % tp or F % tp:
        raise ValueError(
            f"{cfg.name}: heads={H}/kv_heads={K}/d_ff={F} must all divide "
            f"by tp={tp} for the in-stage tensor split"
        )


def restack_params(seg_params: dict, layout: PipelineLayout) -> dict:
    """``[G, ...]`` leaves -> ``[S, C, G/(S*C), ...]``, chunk-major.

    Execution order is (c=0, s=0..S-1), (c=1, s=0..S-1), ...: cell (s, c)
    holds global groups ``(c*S + s)*gpc + j``.  A reshape and a transpose
    of each leaf: a view, so gradients flow back into the canonical leaf.
    """
    S, C, g = layout.pp, layout.n_chunks, layout.groups_per_cell
    return tree_map(
        lambda a: a.view(C, S, g, *a.shape[1:]).transpose(0, 1), seg_params)


def _is_axes(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(a, (str, type(None))) for a in t)


def pipeline_param_specs(cfg: ModelConfig, layout: PipelineLayout) -> dict:
    """Per-leaf spec tree (``parallel.sharding``'s tuples) of the restacked
    segment params: every leaf leads with the stage axis over its ``[S, C,
    g, ...]`` stacking; with ``layout.tp > 1`` the Megatron-sliced weight
    dims (``models.split.tp_slices``: heads / kv-heads / ffn width) also
    shard over ``model``.  Norm scales and biases on replicated dims carry
    no model entry: their gradients are whole on every tensor rank (a norm
    before the split, its output through ``copy_to_tp``) or are summed
    there (a replicated leaf inside the split enters through
    ``copy_to_tp`` itself)."""
    dims = tp_slices(cfg, layout.tp, layout.pp)

    def walk(tree, path):
        if not _is_axes(tree):
            return {k: walk(v, (*path, k)) for k, v in tree.items()}
        rest = [None] * (len(tree) - 1)  # the "layers" axis: restacked to [S, C, g]
        if path in dims:
            rest[dims[path] - 1] = "model"
        return ("stage", None, None, *rest)

    return walk(lm.param_axes(cfg)[layout.seg_key], (layout.seg_key,))


def make_block_fn(
    cfg: ModelConfig,
    layout: PipelineLayout,
    *,
    plain: bool = False,
    split: Split | None = None,
) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """Per-cell apply: runs the cell's ``groups_per_cell`` stacked groups of
    the model's blocks (``lm._block``) over one microbatch activation
    ``[B, S_seq, D]``.

    MegaScope collectors are not threaded into pipelined blocks (captures
    cannot ride the activation wire), so each block runs with
    ``NULL_COLLECTOR``.  Under remat ``"full"`` or ``"dots"`` each group
    runs under ``torch.utils.checkpoint`` (``"dots"`` with
    ``lm.dots_policy``), as ``jax.checkpoint`` wraps JAX's ``apply_group``;
    the fused forward checkpoints each layer, the same thing for one block
    a group.  ``plain=True`` runs the kernels' plain versions.

    With ``layout.tp > 1`` each block runs the Megatron tensor split of
    ``split`` (``models.split``: the mesh's ``model`` axis): the cell's
    weights arrive sliced (``weights.shard_params``) and ``lm._block``
    runs them as the fused forward's blocks run under a split.
    """
    if layout.tp > 1 and (split is None or split.tp != layout.tp):
        raise ValueError(f"tp={layout.tp} blocks need the model axis' split "
                         "(models.split.make_split)")

    def apply_group(gp: dict, x: torch.Tensor) -> torch.Tensor:
        positions = L.arange_positions(x.shape[1], x.device)
        for j, kind in enumerate(layout.kinds):
            x = lm._block(gp[f"b{j}"], cfg, kind, x, positions, None, plain,
                          NULL_COLLECTOR, split=split if layout.tp > 1 else None)[0]
        return x

    if cfg.remat not in ("full", "dots", "none"):
        raise ValueError(f"unknown remat {cfg.remat!r}")

    def group(gp: dict, x: torch.Tensor) -> torch.Tensor:
        if cfg.remat == "none" or not torch.is_grad_enabled():
            return apply_group(gp, x)
        if cfg.remat == "dots":
            return checkpoint(apply_group, gp, x, use_reentrant=False,
                              context_fn=lm._dots_contexts)
        return checkpoint(apply_group, gp, x, use_reentrant=False)

    def block_fn(cell_params: Any, x: torch.Tensor) -> torch.Tensor:
        for j in range(layout.groups_per_cell):
            x = group(lm._layer(cell_params, j), x)
        return x

    return block_fn


def pipeline_forward(
    cfg: ModelConfig,
    params: dict,
    x_micro: torch.Tensor,        # [n_micro, mb, S_seq, D] embedded inputs
    *,
    layout: PipelineLayout,
    table: TimeTable,
    stages: list[torch.device],
    block_fn: Callable | None = None,
) -> torch.Tensor:
    """Pipelined block stack on real weights: returns [n_micro, mb, S, D]."""
    block_fn = block_fn or make_block_fn(cfg, layout)
    stacked = restack_params(params[layout.seg_key], layout)
    return pipeline_apply(stacked, x_micro, table, stages=stages,
                          block_fn=block_fn)


def pipeline_loss(
    cfg: ModelConfig,
    params: dict,
    batch: dict,
    *,
    layout: PipelineLayout,
    table: TimeTable,
    stages: list[torch.device],
    n_micro: int,
    block_fn: Callable | None = None,
    plain: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Full pipelined training loss; same contract as ``lm.loss_fn``.

    Embedding and the norm/cross-entropy head run once over the whole batch
    outside the pipeline, on the first stage's device; the block stack runs
    through the schedule-controlled executor.  The batch splits into
    ``n_micro`` equal microbatches along its first axis; with equal
    per-microbatch token counts the global-mean cross entropy here equals
    the fused step's.  ``block_fn`` defaults to :func:`make_block_fn`'s with
    ``plain``.
    """
    block_fn = block_fn or make_block_fn(cfg, layout, plain=plain)
    x = L.embed_apply(params, cfg, batch["tokens"], getattr(torch, cfg.compute_dtype))
    B, S, D = x.shape
    if B % n_micro != 0:
        raise ValueError(f"global batch {B} not divisible by n_micro={n_micro}")
    mb = B // n_micro
    x_micro = x.reshape(n_micro, mb, S, D)
    hidden = pipeline_forward(cfg, params, x_micro, layout=layout, table=table,
                              stages=stages, block_fn=block_fn)
    return head_loss(cfg, params, hidden.reshape(B, S, D), batch, plain=plain)


def head_loss(cfg: ModelConfig, params: dict, hidden: torch.Tensor, batch: dict,
              *, plain: bool = False) -> tuple[torch.Tensor, dict]:
    """The final norm and the chunked cross entropy of the block stack's
    output ``hidden`` ``[B, S, D]``: ``(ce, metrics)``."""
    hidden = L.norm_apply(params["final_norm"], hidden, cfg.norm_kind,
                          cfg.norm_eps, plain=plain)
    total, count = L.chunked_xent(params, cfg, hidden, batch["targets"],
                                  batch.get("loss_mask"))
    ce = total / torch.clamp(count, min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce, {"loss": ce, "ce": ce, "aux_loss": aux}


def stage_part(tree: dict, layout: PipelineLayout, stage: int) -> dict:
    """Stage ``stage``'s part of a whole tree (parameters, master weights,
    moments or gradients), the part the process of that stage owns: each
    leaf of the layer segment cut to the groups of the stage's cells,
    ``[C * gpc, ...]`` in chunk order (its cell ``c`` holds rows ``c * gpc``
    to ``(c + 1) * gpc``), as a copy of its own; stage 0 also keeps every
    leaf outside the segment (the embedding, the final norm and the head,
    which run there) as it is."""
    S, C, g = layout.pp, layout.n_chunks, layout.groups_per_cell

    def cut(a: torch.Tensor) -> torch.Tensor:
        out = torch.empty((C * g, *a.shape[1:]), dtype=a.dtype, device=a.device)
        out.view(C, g, *a.shape[1:]).copy_(a.detach().view(C, S, g, *a.shape[1:])[:, stage])
        return out

    part = {layout.seg_key: tree_map(cut, tree[layout.seg_key])}
    if stage == 0:
        part.update({k: v for k, v in tree.items() if k != layout.seg_key})
    return part


def merge_stages(parts: list[dict], layout: PipelineLayout) -> dict:
    """The inverse of :func:`stage_part`: the whole tree from every stage's
    part (stage order)."""
    C, g = layout.n_chunks, layout.groups_per_cell
    segs = [p[layout.seg_key] for p in parts]
    whole = dict(parts[0])
    whole[layout.seg_key] = tree_map(
        lambda *a: torch.stack([x.view(C, g, *x.shape[1:]) for x in a], dim=1)
        .reshape(-1, *a[0].shape[1:]), *segs)
    return whole


def _cells(seg: dict, layout: PipelineLayout) -> dict[int, dict]:
    """``{c: cell c's leaves}`` of a stage's segment part, each leaf a
    detached view that takes its own gradient."""
    C, g = layout.n_chunks, layout.groups_per_cell
    return {c: tree_map(lambda a, c=c: a.view(C, g, *a.shape[1:])[c].detach()
                        .requires_grad_(True), seg) for c in range(C)}


def pipeline_ranks_grads(
    cfg: ModelConfig,
    params: dict,
    batch: dict,
    *,
    layout: PipelineLayout,
    table: TimeTable,
    ranks: list[int],
    stage: int,
    n_micro: int,
    block_fn: Callable,
    weight: float | torch.Tensor = 1.0,
    fbd: bool = False,
    plain: bool = False,
) -> tuple[torch.Tensor, dict, dict]:
    """The pipelined loss and gradients with each stage in its own process
    (``ranks``: the global rank of each stage in this process's line;
    ``stage``: this process's), through ``executor.pipeline_ranks_apply``.
    ``params`` is this stage's part of the tree (:func:`stage_part`, and
    under tp its tensor slice).

    Stage 0 embeds ``batch`` (this data rank's rows), splits it into
    ``n_micro`` microbatches and runs the head (final norm and cross
    entropy) on the outputs that come back around the ring; its loss is
    scaled by ``weight`` (this rank's share of the global loss).  Returns
    ``(weighted loss, metrics, grads)``: the loss is 0 off stage 0, and
    ``grads`` has the shape of ``params``.  With ``fbd`` (MegaFBD) the
    backward of stage ``s``'s cells runs on stage ``s + 1``'s process,
    which rebuilds their graphs from the inputs stage ``s`` sends it: each
    stage hands its segment's parameters to that process first and takes
    the gradients of its cells back from it at the end.
    """
    from repro_torch.core.dpp.executor import pipeline_ranks_apply
    from repro_torch.parallel.dist import exchange
    from repro_torch.train.optim import leaves, parent

    S, C = layout.pp, layout.n_chunks
    dtype = getattr(torch, cfg.compute_dtype)
    B, Sq = batch["targets"].shape
    if B % n_micro != 0:
        raise ValueError(f"global batch {B} not divisible by n_micro={n_micro}")
    mb, D = B // n_micro, cfg.d_model
    dev = batch["targets"].device
    seg = params[layout.seg_key]
    prev, nxt = ranks[(stage - 1) % S], ranks[(stage + 1) % S]
    cells = {(stage, c): cell for c, cell in _cells(seg, layout).items()}
    q = stage
    if fbd:
        # this process runs the backward of the stage before it: its
        # parameters, as this step's forward reads them
        q = (stage - 1) % S
        paths, mine = zip(*leaves(seg))
        got = [torch.empty_like(a) for a in mine]
        exchange([(a, nxt) for a in mine], [(b, prev) for b in got])
        seg_q: dict = {}
        for path, b in zip(paths, got):
            node = seg_q
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = b
        cells.update({(q, c): cell for c, cell in _cells(seg_q, layout).items()})
    outer = [(path, leaf) for path, leaf in leaves(params) if path[0] != layout.seg_key]
    loss_w = torch.zeros((), dtype=torch.float32, device=dev)
    outer_grads: list = [None] * len(outer)
    x = x_micro = head = None
    if stage == 0:
        x = L.embed_apply(params, cfg, batch["tokens"], dtype)
        x_micro = list(x.detach().reshape(n_micro, mb, Sq, D))

        def head(outs: list[torch.Tensor]) -> list[torch.Tensor]:
            nonlocal loss_w
            hidden = torch.stack(outs).reshape(B, Sq, D)
            ce, _ = head_loss(cfg, params, hidden, batch, plain=plain)
            loss_w = ce * weight
            g = torch.autograd.grad(loss_w, [*outs, *(leaf for _, leaf in outer)],
                                    allow_unused=True)
            outer_grads[:] = g[len(outs):]
            return list(g[:len(outs)])

    dx_micro, cell_grads = pipeline_ranks_apply(
        cells, x_micro, table, ranks=ranks, stage=stage, block_fn=block_fn,
        act_shape=(mb, Sq, D), act_dtype=dtype, device=dev, head=head, fbd=fbd)

    # the gradients of this stage's cells, [C, g, ...] a leaf
    flat = [[g for _, g in leaves(cell_grads[c])] for c in range(C)]
    if fbd:  # they were taken on the next stage's process
        done = [g for per_c in flat for g in per_c]
        flat = [[torch.empty_like(g) for g in per_c] for per_c in flat]
        exchange([(g, prev) for g in done], [(b, nxt) for per_c in flat for b in per_c])
    grads = {layout.seg_key: tree_map(lambda _: None, seg)}
    for i, (path, _) in enumerate(leaves(seg)):
        parent(grads[layout.seg_key], path)[path[-1]] = torch.stack(
            [per_c[i] for per_c in flat]).reshape(-1, *flat[0][i].shape[1:])
    if stage == 0:
        dx = torch.stack([dx_micro[m] for m in range(n_micro)]).reshape(B, Sq, D)
        emb = torch.autograd.grad(x, [leaf for _, leaf in outer], dx, allow_unused=True)
        with torch.no_grad():
            for (path, leaf), g_head, g_emb in zip(outer, outer_grads, emb):
                g = torch.zeros_like(leaf)
                for part in (g_head, g_emb):
                    if part is not None:
                        g.add_(part)
                node = grads
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = g
    loss_w = loss_w.detach()
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return loss_w, {"loss": loss_w, "ce": loss_w, "aux_loss": aux}, grads
