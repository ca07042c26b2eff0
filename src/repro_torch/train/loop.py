"""Training driver, counterpart of ``repro.train.loop``: a state built from
a seed (or given, or restored from the latest checkpoint), the step applied
to ``SyntheticTokens`` batches, one history row per step, MegaScan's
``Tracer`` scopes ``init`` and ``train_step`` around the work, plugin hooks
(:class:`StepHooks`), async checkpoints every ``ckpt_every`` steps and the
metrics registry's standard train series.

Each step ends by reading its loss back to the host, so the ``train_step``
scope and ``step_s`` cover the card's work, and every value published to
the registry is a host value already read.  A run given a ``ckpt_dir`` that
holds a checkpoint resumes from its latest step and replays
``SyntheticTokens.batch_at(step)`` from there, so it continues the
trajectory of an uninterrupted run.  A pipelined step (a ``plan`` with pp >
1, MegaDPP) adds MegaScan's per-(microbatch, stage, F/B) events to each
step's trace, scaled into its ``train_step`` span.  The fault-tolerance
controller and rank-event injection (MegaFT, ROADMAP queue 1, item 9) and
the compile cache (item 12b) are later slices; asking for them raises.
"""

from __future__ import annotations

import gc
import logging
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step, restore
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dpp.executor import emit_pipeline_events
from repro_torch.core.flops import count_flops
from repro_torch.core.tracing.tracer import Tracer
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models.hooks import NULL_COLLECTOR
from repro_torch.models.model import get_model
from repro_torch.train.optim import OptimizerConfig, leaves
from repro_torch.train.train_step import (
    init_train_state,
    make_train_step,
    to_device_batch,
)

log = logging.getLogger("repro_torch.train")


@dataclass
class LoopConfig:
    n_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    seed: int = 0
    grad_accum: int = 1


@dataclass
class StepHooks:
    """Plugin attach points threaded in by ``repro_torch.app.Session``.

    ``wrap_step`` decorates the step callable once, before the loop;
    ``on_step(events, metrics)`` observes each completed step — the MegaScan
    ``TraceEvent``s it appended and its metrics (0-dim tensors, the loss
    already read back; a MegaScope collector's ``captures``, still on the
    device).
    """

    wrap_step: Callable[[Callable], Callable] | None = None
    on_step: Callable[[list, dict], None] | None = None


def refuse_embeds(cfg: ModelConfig) -> None:
    """The loop feeds ``SyntheticTokens`` batches, which carry no
    embeddings: an embeds arch (qwen2-vl) is refused before its first step,
    where the JAX loop stops with ``KeyError: 'embeds'`` (ROADMAP R8)."""
    if cfg.input_kind != "tokens":
        raise ValueError(
            f"{cfg.name}: the train loop feeds token batches (SyntheticTokens) "
            f"and an {cfg.input_kind} arch takes input embeddings, which no data "
            "pipeline makes (ROADMAP R8); train it through make_train_step on "
            "models.model.make_batch batches")


def _refuse(**later: tuple[Any, str]) -> None:
    for name, (value, item) in later.items():
        if value is not None:
            raise NotImplementedError(
                f"{name} is ported in a later slice (ROADMAP queue 1, {item})")


def step_flops(cfg: ModelConfig, state, batch: dict,
               loss_fn: Callable | None = None) -> float:
    """Model flops of one step on ``batch``: the products of one forward and
    backward of the loss (:func:`repro_torch.core.flops.count_flops`),
    taken outside the timed steps; the state is not updated.  ``loss_fn
    (params, batch) -> (loss, metrics)`` defaults to the model's fused loss;
    a pipelined step passes its own."""
    if loss_fn is None:
        model = get_model(cfg)
        loss_fn = lambda p, b: model.loss_fn(cfg, p, b)  # noqa: E731
    params = [leaf for _, leaf in leaves(state.params)]
    dev = params[0].device

    def fwd_bwd():
        loss, _ = loss_fn(state.params, to_device_batch(batch, dev))
        torch.autograd.grad(loss, params)

    return float(count_flops(fwd_bwd))


def _publish_step_metrics(registry, row: dict, *, tokens: int, flops: float,
                          device: torch.device) -> None:
    """One step's standard series into the MetricsRegistry, from the host
    values of its history row (the JAX loop's ``_publish_step_metrics``)."""
    step_s = row["step_s"]
    registry.counter("train.steps").inc()
    registry.counter("train.tokens").inc(tokens)
    registry.histogram("train.step_time_s").observe(step_s)
    registry.gauge("train.tokens_per_s").set(tokens / max(step_s, 1e-9))
    if flops:
        registry.histogram("train.model_flops_per_s").observe(
            flops / max(step_s, 1e-9))
    for k in ("loss", "grad_norm", "lr"):
        registry.gauge(f"train.{k}").set(row[k])
    if device.type == "cuda":  # the allocator's own count: no device sync
        registry.gauge("train.device_mem_bytes").set(
            torch.cuda.memory_allocated(device))


def train(
    cfg: ModelConfig,
    ocfg: OptimizerConfig,
    data_cfg: DataConfig,
    loop: LoopConfig,
    *,
    collector=NULL_COLLECTOR,
    tracer: Tracer | None = None,
    state=None,
    device: str | torch.device = "cuda",
    hooks: StepHooks | None = None,
    plan=None,
    registry=None,
    obs=None,
    controller=None,
    compile_cache=None,
) -> tuple[Any, list[dict]]:
    """Returns ``(state, history)``; a history row per step run holds
    ``step`` (1-based), ``loss``, ``lr``, ``grad_norm``, ``step_s`` and
    ``tokens_per_s``.  ``registry`` (a ``repro_torch.obs.MetricsRegistry``)
    receives the standard train series each step; its
    ``train.model_flops_per_s`` comes from :func:`step_flops`, counted once
    before the first step.  ``collector`` (MegaScope) rides every step's
    loss; its captures reach ``hooks.on_step`` in the step's metrics.
    ``plan`` (a ``ParallelPlan``) with pp > 1 trains through the pipeline
    step; each step's trace then holds its ``pp_F``/``pp_B`` events."""
    _refuse(compile_cache=(compile_cache, "item 12b"),
            obs=(obs, "item 9"), controller=(controller, "item 9"))
    refuse_embeds(cfg)
    dev = resolve_device(device)
    tracer = tracer or Tracer(rank=0, enabled=True)
    ds = SyntheticTokens(data_cfg)
    if state is None:
        with tracer.scope("init", op="init"):
            state = init_train_state(cfg, seed=loop.seed, device=dev)
    step_fn = make_train_step(cfg, ocfg, grad_accum=loop.grad_accum,
                              collector=collector, plan=plan)
    pp_info = getattr(step_fn, "pipeline", None)
    if hooks is not None and hooks.wrap_step is not None:
        step_fn = hooks.wrap_step(step_fn)

    start = 0
    ckpt = None
    if loop.ckpt_dir:
        ckpt = Checkpointer(loop.ckpt_dir)
        last = latest_step(loop.ckpt_dir)
        if last is not None:
            state, _ = restore(loop.ckpt_dir, state)
            start = last
            log.info("restored checkpoint at step %d", start)

    # the MFU numerator, once, only when someone will read the series
    flops = 0.0
    if registry is not None:
        flops = step_flops(cfg, state, ds.batch_at(start),
                           pp_info.loss_fn if pp_info is not None else None)
        # the count imports and allocates a great many Python objects: a
        # full collection now keeps Python's next one out of the timed steps
        gc.collect()
    tokens_per_step = data_cfg.global_batch * data_cfg.seq_len

    history: list[dict] = []
    for step in range(start, loop.n_steps):
        batch = ds.batch_at(step)
        n_ev = len(tracer.events)
        t_step = time.perf_counter()
        with tracer.scope("train_step", op="train_step", mb=step):
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the card
        step_s = time.perf_counter() - t_step
        if pp_info is not None and tracer.enabled:
            # the train_step scope just closed; fold its wall into
            # per-(microbatch, stage, F/B) pipeline events
            anchor = tracer.events[-1]
            emit_pipeline_events(tracer.events, pp_info.table, ts=anchor.ts,
                                 wall=anchor.dur, step_idx=step)
        row = {"step": step + 1, "loss": loss, "lr": float(metrics["lr"]),
               "grad_norm": float(metrics["grad_norm"]), "step_s": step_s,
               "tokens_per_s": tokens_per_step / max(step_s, 1e-9)}
        history.append(row)
        if registry is not None:
            _publish_step_metrics(registry, row, tokens=tokens_per_step,
                                  flops=flops, device=dev)
        if hooks is not None and hooks.on_step is not None:
            hooks.on_step(tracer.events[n_ev:], metrics)
        if (step + 1) % max(loop.log_every, 1) == 0 or step == loop.n_steps - 1:
            log.info("step %d: loss=%.4f lr=%.2e", step + 1, loss, row["lr"])
        if ckpt and (step + 1) % loop.ckpt_every == 0:
            ckpt.save_async(state, step + 1, metadata={"arch": cfg.name})
    if ckpt:
        ckpt.wait()
    return state, history
