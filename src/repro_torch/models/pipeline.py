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
thread), and no tensor parallelism inside the stages yet (ROADMAP item 8b:
``pipeline_param_specs`` and the per-rank config come with it).
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
        raise NotImplementedError(
            f"tensor parallelism inside the pipeline (tp={tp}) is ported with "
            "data and tensor parallelism (ROADMAP queue 1, item 8b)")
    return PipelineLayout("seg0", tuple(kinds), n_groups, pp, n_chunks,
                          n_groups // cells, tp)


def restack_params(seg_params: dict, layout: PipelineLayout) -> dict:
    """``[G, ...]`` leaves -> ``[S, C, G/(S*C), ...]``, chunk-major.

    Execution order is (c=0, s=0..S-1), (c=1, s=0..S-1), ...: cell (s, c)
    holds global groups ``(c*S + s)*gpc + j``.  A reshape and a transpose
    of each leaf: a view, so gradients flow back into the canonical leaf.
    """
    S, C, g = layout.pp, layout.n_chunks, layout.groups_per_cell
    return tree_map(
        lambda a: a.view(C, S, g, *a.shape[1:]).transpose(0, 1), seg_params)


def make_block_fn(
    cfg: ModelConfig,
    layout: PipelineLayout,
    *,
    plain: bool = False,
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
    """
    def apply_group(gp: dict, x: torch.Tensor) -> torch.Tensor:
        positions = L.arange_positions(x.shape[1], x.device)
        for j, kind in enumerate(layout.kinds):
            x = lm._block(gp[f"b{j}"], cfg, kind, x, positions, None, plain,
                          NULL_COLLECTOR)[0]
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
    hidden = hidden.reshape(B, S, D)
    hidden = L.norm_apply(params["final_norm"], hidden, cfg.norm_kind,
                          cfg.norm_eps, plain=plain)
    total, count = L.chunked_xent(params, cfg, hidden, batch["targets"],
                                  batch.get("loss_mask"))
    ce = total / torch.clamp(count, min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce, {"loss": ce, "ce": ce, "aux_loss": aux}
