"""Family dispatch and helpers, counterpart of ``repro.models.model``.

The decoder LM is ported for the dense (with qwen2-vl's embeds inputs and
M-RoPE), MoE (with deepseek-v2-lite's MLA attention), RWKV-6 and Griffin
families: :func:`get_model` returns its entry points and refuses the
encoder-decoder family, which arrives with a later slice (ROADMAP queue 1,
item 13b).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


@dataclass(frozen=True)
class Model:
    init: Callable
    loss_fn: Callable


LM = Model(init=lm.init, loss_fn=lm.loss_fn)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is ported in a later "
            "slice (ROADMAP queue 1, item 13b)")
    return LM


def make_batch(cfg: ModelConfig, batch: int, seq: int, rng: np.random.Generator,
               device: str | torch.device = "cpu") -> dict:
    """A synthetic training batch matching the arch's input kind, drawn from
    ``rng`` (JAX draws its own from a key; tests hand both sides one numpy
    batch): token ids, or for an embeds arch float32 N(0, 1) ``embeds``
    ``[batch, seq, d_model]`` and, under M-RoPE, ``mrope_position_ids``
    ``[3, batch, seq]``, three equal streams of ``arange(seq)``; int32
    ``targets``."""
    get_model(cfg)  # refuses the encoder-decoder family (its tokens too)
    draw = lambda: torch.from_numpy(  # noqa: E731
        rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32))
    if cfg.input_kind == "tokens":
        out = {"tokens": draw()}
    else:
        out = {"embeds": torch.from_numpy(
            rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32))}
        if cfg.input_kind == "embeds_mrope":
            pos = torch.arange(seq, dtype=torch.int32).expand(batch, seq)
            out["mrope_position_ids"] = torch.stack([pos, pos, pos])
    out["targets"] = draw()
    return {k: v.to(device) for k, v in out.items()}


def count_params(params: dict) -> int:
    return sum(v.numel() if isinstance(v, torch.Tensor) else count_params(v)
               for v in params.values())
