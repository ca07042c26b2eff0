"""Training driver, counterpart of ``repro.train.loop`` reduced to its core:
a state built from a seed (or given), the step applied to
``SyntheticTokens`` batches, one history row per step, and MegaScan's
``Tracer`` scopes ``init`` and ``train_step`` around the work.

Each step ends by reading its loss back to the host, so the ``train_step``
scope and ``step_s`` cover the card's work.  Checkpointing, ``StepHooks``,
the metrics registry, rank-event injection and the fault-tolerance
controller are later slices; asking for them raises.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tracing.tracer import Tracer
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.train.optim import OptimizerConfig
from repro_torch.train.train_step import init_train_state, make_train_step

log = logging.getLogger("repro_torch.train")


@dataclass
class LoopConfig:
    n_steps: int = 100
    log_every: int = 10
    ckpt_dir: str | None = None
    seed: int = 0
    grad_accum: int = 1


def _refuse(**later: tuple[Any, str]) -> None:
    for name, (value, item) in later.items():
        if value is not None:
            raise NotImplementedError(
                f"{name} is ported in a later slice (ROADMAP queue 1, {item})")


def train(
    cfg: ModelConfig,
    ocfg: OptimizerConfig,
    data_cfg: DataConfig,
    loop: LoopConfig,
    *,
    tracer: Tracer | None = None,
    state=None,
    device: str | torch.device = "cuda",
    hooks=None,
    plan=None,
    registry=None,
    obs=None,
    controller=None,
    compile_cache=None,
) -> tuple[Any, list[dict]]:
    """Returns ``(state, history)``; a history row per step holds ``step``
    (1-based), ``loss``, ``lr``, ``grad_norm``, ``step_s`` and
    ``tokens_per_s``."""
    _refuse(ckpt_dir=(loop.ckpt_dir, "item 4"), hooks=(hooks, "item 4"),
            registry=(registry, "item 4"), compile_cache=(compile_cache, "item 12"),
            obs=(obs, "item 9"), controller=(controller, "item 9"))
    dev = resolve_device(device)
    tracer = tracer or Tracer(rank=0, enabled=True)
    ds = SyntheticTokens(data_cfg)
    if state is None:
        with tracer.scope("init", op="init"):
            state = init_train_state(cfg, seed=loop.seed, device=dev)
    step_fn = make_train_step(cfg, ocfg, grad_accum=loop.grad_accum, plan=plan)
    tokens_per_step = data_cfg.global_batch * data_cfg.seq_len

    history: list[dict] = []
    for step in range(loop.n_steps):
        batch = ds.batch_at(step)
        t_step = time.perf_counter()
        with tracer.scope("train_step", op="train_step", mb=step):
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the card
        step_s = time.perf_counter() - t_step
        row = {"step": step + 1, "loss": loss, "lr": float(metrics["lr"]),
               "grad_norm": float(metrics["grad_norm"]), "step_s": step_s,
               "tokens_per_s": tokens_per_step / max(step_s, 1e-9)}
        history.append(row)
        if (step + 1) % max(loop.log_every, 1) == 0 or step == loop.n_steps - 1:
            log.info("step %d: loss=%.4f lr=%.2e", step + 1, loss, row["lr"])
    return state, history
