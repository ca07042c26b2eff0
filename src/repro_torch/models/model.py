"""Family dispatch and helpers, counterpart of ``repro.models.model``: a
uniform entry to ``lm.py`` (the dense, MoE with MLA, RWKV-6 and Griffin
families) and ``encdec.py`` (the encoder-decoder family).

    m = get_model(cfg)
    params = m.init(cfg, seed=0, device=..., dtype=...)
    axes = m.param_axes(cfg)     # logical axis names, leaf by leaf
    loss, metrics = m.loss_fn(cfg, params, batch)
    cache = m.init_cache(cfg, batch_size, cache_len[, src_len], device=...)
    logits, captures = m.prefill(cfg, params, batch, cache)
    logits, captures = m.decode_step(cfg, params, cache, tokens, pos)

Caches are updated in place, where JAX returns them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm


@dataclass(frozen=True)
class Model:
    init: Callable
    loss_fn: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    param_axes: Callable


LM = Model(init=lm.init, loss_fn=lm.loss_fn, init_cache=lm.init_cache,
           prefill=lm.prefill, decode_step=lm.decode_step,
           param_axes=lm.param_axes)
ENCDEC = Model(init=encdec.init, loss_fn=encdec.loss_fn, init_cache=encdec.init_cache,
               prefill=encdec.prefill, decode_step=encdec.decode_step,
               param_axes=encdec.param_axes)


def get_model(cfg: ModelConfig) -> Model:
    return ENCDEC if cfg.family == "encdec" else LM


def make_batch(cfg: ModelConfig, batch: int, seq: int, rng: np.random.Generator,
               device: str | torch.device = "cpu") -> dict:
    """A synthetic training batch matching the arch's input kind, drawn from
    ``rng`` (JAX draws its own from a key; tests hand both sides one numpy
    batch): token ids, or for an embeds arch float32 N(0, 1) ``embeds``
    ``[batch, seq, d_model]``, with the encoder-decoder's target ``tokens``
    or, under M-RoPE, ``mrope_position_ids`` ``[3, batch, seq]``, three
    equal streams of ``arange(seq)``; int32 ``targets``."""
    draw = lambda: torch.from_numpy(  # noqa: E731
        rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32))
    if cfg.input_kind == "tokens":
        out = {"tokens": draw()}
    else:
        out = {"embeds": torch.from_numpy(
            rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32))}
        if cfg.family == "encdec":
            out["tokens"] = draw()
        if cfg.input_kind == "embeds_mrope":
            pos = torch.arange(seq, dtype=torch.int32).expand(batch, seq)
            out["mrope_position_ids"] = torch.stack([pos, pos, pos])
    out["targets"] = draw()
    return {k: v.to(device) for k, v in out.items()}


def count_params(params: dict) -> int:
    return sum(v.numel() if isinstance(v, torch.Tensor) else count_params(v)
               for v in params.values())


def active_param_count(cfg: ModelConfig) -> int:
    """Active parameters a token (the ``6 * N_active * tokens`` model-flops
    numerator), JAX ``active_param_count``: MoE layers count ``top_k`` of
    their ``num_experts`` experts."""
    total = _dense_param_count(cfg)
    if cfg.family == "moe":
        mo = cfg.moe
        expert_p = 3 * cfg.d_model * mo.expert_d_ff
        n_moe_layers = cfg.num_layers - mo.first_k_dense
        total -= n_moe_layers * mo.num_experts * expert_p
        total += n_moe_layers * mo.top_k * expert_p
    return total


def _dense_param_count(cfg: ModelConfig) -> int:
    """Parameters from the shapes of ``init`` on the meta device, less the
    input embedding (a gather, not a product) unless it is tied, where the
    one table is also the unembedding's product."""
    n = count_params(get_model(cfg).init(cfg, device="meta"))
    if not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.d_model
    return n
