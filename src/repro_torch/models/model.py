"""Family dispatch and helpers, counterpart of ``repro.models.model``.

Only the dense decoder LM is ported: :func:`get_model` returns its entry
points and refuses the encoder-decoder family, which arrives with a later
slice (ROADMAP queue 1, item 13).
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
            "slice (ROADMAP queue 1, item 13)")
    return LM


def make_batch(cfg: ModelConfig, batch: int, seq: int, rng: np.random.Generator,
               device: str | torch.device = "cpu") -> dict:
    """A synthetic training batch of token ids drawn from ``rng`` (JAX draws
    its own from a key; tests hand both sides one numpy batch)."""
    if cfg.input_kind != "tokens":
        raise NotImplementedError(f"{cfg.name}: embeds inputs are a later slice")
    draw = lambda: torch.from_numpy(  # noqa: E731
        rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32))
    return {"tokens": draw().to(device), "targets": draw().to(device)}


def count_params(params: dict) -> int:
    return sum(v.numel() if isinstance(v, torch.Tensor) else count_params(v)
               for v in params.values())
