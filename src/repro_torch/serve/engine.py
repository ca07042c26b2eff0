"""MegaServe engine steps over the paged KV pool.

Counterparts of ``repro.serve.engine.make_paged_decode_step`` and
``make_flash_prefill_step``.  Each factory returns a step that runs one
``lm.forward`` straight against the layer-stacked pool, which it updates in
place (the JAX package jits the same step with the pool donated).  PyTorch
runs eagerly, so there is nothing to compile and no per-width executable.

``plain=True`` builds the same step over the plain PyTorch attention versions
on any device: the teacher-forced reference that the kernels are held to on
the card.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention.ops import PagedInfo
from repro_torch.models import layers as L
from repro_torch.models import lm


def _check_servable(cfg: ModelConfig) -> None:
    if cfg.input_kind != "tokens":
        raise ValueError(f"{cfg.name}: continuous batching serves token archs")
    lm.require_paged(cfg)  # raises for the families of later slices


def make_paged_decode_step(
    cfg: ModelConfig, *, block_size: int, plain: bool = False,
) -> Callable:
    """Returns ``step(params, pool, tables [S, M] int32, tokens [S],
    pos [S] int32) -> logits [S, V]``: one batched decode over all slots.

    Slots ride the batch axis of a single ``lm.forward`` with per-slot
    positions; each slot's new K/V go into the pool block that owns ``pos``,
    and attention walks ``tables`` (which may be sliced to the live-block
    high-water mark), so per-step cost is O(live kv_len), not O(pool).
    """
    _check_servable(cfg)

    @torch.inference_mode()
    def step(params, pool, tables, tokens, pos):
        paged = PagedInfo(tables=tables, block_size=block_size, plain=plain)
        hidden, _ = lm.forward(cfg, params, tokens[:, None], pool=pool,
                               cache_pos=pos, paged=paged)
        return L.logits_fn(params, cfg, hidden)[:, 0]

    return step


def make_flash_prefill_step(
    cfg: ModelConfig, *, block_size: int, plain: bool = False,
) -> Callable:
    """Returns ``step(params, pool, tables [1, M] int32, tokens [1, P],
    n_real) -> last_logits [V]``: the whole (right-padded) prompt in one call
    straight into the slot's pool blocks via the flash-prefill kernel.

    ``q_start=0`` pins query 0 at position 0, so attention covers only the
    causal lower triangle.  Pad tokens past ``n_real`` write K/V beyond the
    slot's ``kv_len`` (or into the null block), where every later read masks
    them and the first decode write overwrites them.
    """
    _check_servable(cfg)

    @torch.inference_mode()
    def step(params, pool, tables, tokens, n_real):
        paged = PagedInfo(tables=tables, block_size=block_size, prefill=True,
                          q_start=0, plain=plain)
        pos = torch.zeros((1,), dtype=torch.int32, device=tokens.device)
        hidden, _ = lm.forward(cfg, params, tokens, pool=pool, cache_pos=pos,
                               paged=paged)
        last = hidden[:, n_real - 1:n_real]
        return L.logits_fn(params, cfg, last)[0, 0]

    return step
