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
step's trace, scaled into its ``train_step`` span.  With a compile cache
(``compile_cache=``) the step's kernel libraries are built or loaded
through it before step 0 (:func:`_warm_train_step`).

With a :class:`repro_torch.ft.FtController` (the ``ft`` module plugin) the
loop is supervised, as the JAX loop is: a chaos-injected crash, a
mitigation-requested exclusion restart or a guard rollback restores the
latest checkpoint and resumes, bounded by ``ft.max_restarts`` with
exponential backoff, and step-indexed batches make the replayed trajectory
the fault-free one.  The controller's pending actions execute at a step's
top: int8 gradient sync (``GradCompressor``) for a degraded data link, a
MegaDPP wave replan around a slow stage at pp > 1, or an exclusion
restart.  ``obs`` (a ``repro_torch.obs.RankEventSpec``) adds per-rank
events to each step's trace and can induce a straggler, a sleep inside the
step's span.  In a world of ranks, rank 0 decides and sends every rank the
actions at each step's top, so all of them act at the same step.
"""

from __future__ import annotations

import gc
import json
import logging
import time
from dataclasses import dataclass, replace
from types import SimpleNamespace
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step, restore
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dpp.executor import emit_pipeline_events
from repro_torch.core.dpp.planner import Planner
from repro_torch.core.flops import count_flops
from repro_torch.core.simkit.workload import ModelProfile
from repro_torch.core.tracing.tracer import Tracer
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.ft.chaos import InjectedCrash
from repro_torch.ft.compress import GradCompressor
from repro_torch.models.hooks import NULL_COLLECTOR
from repro_torch.models.model import get_model
from repro_torch.obs.inject import emit_rank_events
from repro_torch.train.optim import OptimizerConfig, leaves, tree_map
from repro_torch.train.train_step import (
    copy_state,
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


class _MitigationRestart(RuntimeError):
    """The controller decided EXCLUDE_RESTART: roll back and resume."""


class _GuardRollback(RuntimeError):
    """An in-band guard tripped with guard_action=rollback."""


def _route_links(plan, links) -> tuple[list, list]:
    """Split detected degraded links by the mesh axis they live on, as the
    JAX loop does: without a plan every link is a data link; with one, both
    endpoints map through the plan's topology (``parallel.plan.link_axis``)
    and links across ``data`` carry the gradient sync (compressible), links
    across ``stage`` the pipeline's hand-offs (replannable); anything else
    mitigates as neither."""
    links = [tuple(l) for l in (links or [])]
    if plan is None:
        return links, []
    from repro_torch.parallel.plan import link_axis

    data = [l for l in links if link_axis(plan, l) == "data"]
    stage = [l for l in links if link_axis(plan, l) == "stage"]
    return data, stage


def step_flops(cfg: ModelConfig, state, batch: dict,
               loss_fn: Callable | None = None, *,
               meta: bool | None = None) -> float:
    """Model flops of one step on ``batch``: the products of one forward and
    backward of the loss (:func:`repro_torch.core.flops.count_flops`); the
    state is not updated.  With ``meta`` (the default for a state on the
    card) the pass runs on the meta device over stand-ins of the
    parameters and the batch, so nothing runs on the card and the count is
    the same integer as a real pass's; otherwise it runs where the state
    lies.  ``loss_fn (params, batch) -> (loss, metrics)`` defaults to the
    model's fused loss; a pipelined step passes its own."""
    if loss_fn is None:
        model = get_model(cfg)
        loss_fn = lambda p, b: model.loss_fn(cfg, p, b)  # noqa: E731
    params = state.params
    dev = next(leaves(params))[1].device
    if dev.type == "cuda" if meta is None else meta:
        dev = torch.device("meta")
        params = tree_map(lambda p: torch.empty_like(p, device=dev)
                          .requires_grad_(True), params)
    flat = [leaf for _, leaf in leaves(params)]

    def fwd_bwd():
        loss, _ = loss_fn(params, to_device_batch(batch, dev))
        torch.autograd.grad(loss, flat, allow_unused=True)

    return float(count_flops(fwd_bwd))


def _warm_train_step(cfg: ModelConfig, state, batch: dict, cache, *,
                     loss_fn: Callable | None, key_parts: dict,
                     registry) -> None:
    """The train step's kernels through the persistent compile cache
    before step 0, the JAX loop's ``_aot_train_step``: the cache becomes
    the process's kernel build cache (``kernels._build.use_cache``, Triton's
    cache under it too) and the step's entry records the libraries it
    launches, read from a pass of its loss on the meta device; a hit loads
    them straight from the cache, a miss builds them (in parallel) and puts
    the record.  A step on the CPU launches no kernel.  Logs "cache hit" or
    "compiled" and sets the ``train.precompile_ms`` gauge."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.use_cache(cache)
    key = cache.key(**key_parts)
    blob = cache.load(key)
    if blob is not None:
        libs = json.loads(blob)["libraries"]
    elif next(leaves(state.params))[1].device.type == "cuda":
        _build.meta_calls.clear()
        step_flops(cfg, state, batch, loss_fn, meta=True)
        libs = sorted(_build.meta_calls)
    else:
        libs = []
    _build.build(libs)
    for name in libs:
        _build.load(name)
    if blob is None:
        cache.put(key, json.dumps({"libraries": libs}).encode())
    ms = (time.perf_counter() - t0) * 1e3
    log.info("train step kernels %s in %.0f ms",
             "cache hit" if blob is not None else "compiled", ms)
    if registry is not None:
        registry.gauge("train.precompile_ms").set(ms)


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
    mesh=None,
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
    step; each step's trace then holds its ``pp_F``/``pp_B`` events.
    ``mesh`` (``launch.mesh.make_pipeline_mesh``) runs the plan on this
    rank of a world (``train_step.make_train_step``): every rank draws the
    whole master (or restores the whole state) and keeps the part it owns;
    rank 0 alone logs and writes checkpoints, the whole tree gathered from
    the ranks' parts; the step's flops are not counted (its work is
    spread over the ranks).

    ``obs`` and ``controller`` (MegaFT) are as in the JAX loop.  A failure
    is recovered only under a controller with a ``ckpt_dir`` and within
    ``max_restarts``; otherwise it re-raises.  A refusal
    (``NotImplementedError``) is never recovered, and in a world only the
    failures that fire on every rank at once are: an injected crash, a
    guard rollback, an exclusion restart.  Recovery drains the background
    save (rank 0), waits for every rank, restores the whole tree from the
    latest checkpoint (each rank keeps its part), zeroes the compression
    error buffers and cuts the history at the restored step.

    ``compile_cache`` (a ``repro_torch.core.compile_cache.CompileCache``)
    builds or loads the step's kernels through it before step 0
    (:func:`_warm_train_step`); in a world of ranks it only holds each
    rank's builds."""
    refuse_embeds(cfg)
    dev = resolve_device(device)
    tracer = tracer or Tracer(rank=0, enabled=True)
    ds = SyntheticTokens(data_cfg)
    if controller is not None:
        controller.registry = registry

    def build(plan_, compressor=None):
        """(Re)build the wrapped step: also the mitigation rebuild path
        (compression on, schedule replanned)."""
        raw = make_train_step(cfg, ocfg, grad_accum=loop.grad_accum,
                              collector=collector, plan=plan_, mesh=mesh,
                              compressor=compressor)
        fn = raw
        if hooks is not None and hooks.wrap_step is not None:
            fn = hooks.wrap_step(raw)
        return fn, raw

    step_fn, raw = build(plan)
    pp_info = getattr(raw, "pipeline", None)
    par_info = getattr(raw, "parallel", None)
    lead = par_info is None or par_info.mesh.get_rank() == 0

    start = 0
    ckpt = None
    last = latest_step(loop.ckpt_dir) if loop.ckpt_dir else None
    whole = True
    if state is None:
        with tracer.scope("init", op="init"):
            if par_info is not None and last is None:
                # this rank's part only, cut from the whole master
                state = par_info.local_state(
                    get_model(cfg).init(cfg, seed=loop.seed, device=dev))
                whole = False
            else:
                state = init_train_state(cfg, seed=loop.seed, device=dev)
    if loop.ckpt_dir:
        ckpt = Checkpointer(loop.ckpt_dir) if lead else None
        if last is not None:
            state, _ = restore(loop.ckpt_dir, state)
            start = last
            if lead:
                log.info("restored checkpoint at step %d", start)
    if par_info is not None and whole:
        state = par_info.shard_state(state)

    def save(state, step: int) -> None:
        # in a world, every rank sends its part and rank 0 saves the whole
        # tree in the one-process format
        saved = state if par_info is None else par_info.gather_state(state)
        if ckpt:
            ckpt.save_async(saved, step, metadata={"arch": cfg.name})

    if controller is not None and loop.ckpt_dir and last is None:
        if par_info is not None:
            dist.barrier()  # every rank has looked for a checkpoint first
        # supervised runs always have a rollback target, even before the
        # first periodic save lands
        save(state, 0)

    if compile_cache is not None and par_info is not None:
        # a rank holds a part of the model: its step's kernels build into
        # the cache at their first launch, with no record of the step
        from repro_torch.kernels import _build

        _build.use_cache(compile_cache)
    elif compile_cache is not None:
        from repro_torch.core.compile_cache import mesh_descriptor

        _warm_train_step(
            cfg, state, ds.batch_at(start), compile_cache,
            loss_fn=pp_info.loss_fn if pp_info is not None else None,
            registry=registry,
            key_parts={
                "model": cfg, "opt": ocfg, "data": data_cfg,
                "grad_accum": loop.grad_accum, "plan": plan,
                "mesh": mesh_descriptor(mesh),
                "state": [f"{tuple(t.shape)}/{t.dtype}/{t.device.type}"
                          for _, t in leaves(state.params)],
            })

    # the MFU numerator, once, only when someone will read the series:
    # counted on the meta device, so nothing runs on the card for it
    flops = 0.0
    if registry is not None and par_info is not None:
        log.info("train.model_flops_per_s is not published across %d ranks",
                 par_info.plan.world)
    elif registry is not None:
        flops = step_flops(cfg, state, ds.batch_at(start),
                           pp_info.loss_fn if pp_info is not None else None)
        # the count imports and allocates a great many Python objects: a
        # full collection now keeps Python's next one out of the timed steps
        gc.collect()
    tokens_per_step = data_cfg.global_batch * data_cfg.seq_len

    opts = controller.options if controller is not None else None
    guards_on = opts is not None and (opts.guard_nan or opts.guard_spike > 0)
    skip_guard = guards_on and opts.guard_action == "skip"
    max_restarts = opts.max_restarts if opts is not None else 0
    backoff_s = opts.backoff_s if opts is not None else 0.0
    comp = None            # GradCompressor once the mitigation activates
    comp_err = None        # its error-feedback buffers
    comp_wire = (0, 0)     # (compressed, bf16-baseline) bytes per step

    history: list[dict] = []
    step = start
    attempts = 0
    while step < loop.n_steps:
        try:
            if controller is not None:
                acts = controller.poll()
                if par_info is not None:
                    # rank 0 decides; every rank acts on its decisions
                    box = [acts]
                    dist.broadcast_object_list(box, src=0)
                    acts = box[0]
                for act in acts:
                    data_links, stage_links = _route_links(plan, act.degraded_links)
                    if act.kind == "exclude":
                        controller.excluded.update(act.slow_ranks)
                        controller.record(step, "mitigate:exclude", {
                            "ranks": sorted(act.slow_ranks),
                            "detect_step": act.detect_step,
                            "restart": bool(loop.ckpt_dir),
                        })
                        if loop.ckpt_dir:
                            raise _MitigationRestart(
                                f"excluding ranks {sorted(act.slow_ranks)}")
                        log.warning("ft: excluding %s without restart "
                                    "(no ckpt_dir)", sorted(act.slow_ranks))
                    elif data_links and comp is None and (
                            plan is None or plan.pp <= 1 or plan.dp > 1):
                        # a data-axis link has a gradient sync to compress
                        comp = GradCompressor()
                        step_fn, raw = build(plan, compressor=comp)
                        comp_err = comp.init(state.master)
                        comp_wire = comp.wire_bytes(state.master)
                        controller.replans += 1
                        controller.compression_on = True
                        controller.record(step, "mitigate:compress_on", {
                            "links": [list(l) for l in data_links],
                            "detect_step": act.detect_step,
                            "wire_bytes_per_sync": comp_wire[0],
                            "baseline_bytes_per_sync": comp_wire[1],
                        })
                        log.warning(
                            "ft: int8 gradient sync ON (%.2fx wire bytes) "
                            "for degraded links %s",
                            comp_wire[0] / max(comp_wire[1], 1),
                            [list(l) for l in data_links])
                    elif (act.slow_ranks or stage_links) and plan is not None \
                            and plan.pp > 1:
                        # slow ranks or degraded stage-axis links: route
                        # around them with a MegaDPP wave re-plan
                        planner = Planner(plan.topology(),
                                          ModelProfile(n_chunks=plan.n_chunks),
                                          n_micro=plan.n_micro_local)
                        res = planner.replan(SimpleNamespace(
                            slow_ranks=list(act.slow_ranks),
                            degraded_links=stage_links))
                        plan = replace(plan, schedule="wave", wave=res.wave)
                        step_fn, raw = build(plan, compressor=comp)
                        pp_info = raw.pipeline
                        controller.replans += 1
                        controller.record(step, "mitigate:replan_schedule", {
                            "slow_ranks": sorted(act.slow_ranks),
                            "detect_step": act.detect_step,
                            "wave": res.wave,
                            "makespan_ms": round(res.makespan * 1e3, 3),
                        })
                        log.warning("ft: replanned pipeline schedule -> "
                                    "wave=%d around slow ranks %s",
                                    res.wave, sorted(act.slow_ranks))
                    else:
                        controller.record(step, "mitigate:replan_noop", {
                            "slow_ranks": sorted(act.slow_ranks),
                            "detect_step": act.detect_step,
                        })
                if controller.crash_due(step):
                    raise InjectedCrash(f"chaos: injected crash at step {step}")

            batch = ds.batch_at(step)
            eff_obs = obs
            if controller is not None:
                eff_obs = controller.effective_obs(obs, step)
                batch = controller.poison_batch(batch, step)
            # the step updates the state in place: a skip guard keeps a
            # copy of the pre-step state (and error buffers) to fall back on
            prev = None
            if skip_guard:
                prev = (copy_state(state), None if comp_err is None
                        else tree_map(torch.clone, comp_err))
            n_ev = len(tracer.events)
            t_step = time.perf_counter()
            with tracer.scope("train_step", op="train_step", mb=step):
                if comp is None:
                    state, metrics = step_fn(state, batch)
                else:
                    state, comp_err, metrics = step_fn(state, comp_err, batch)
                loss = float(metrics["loss"])  # waits for the card
                extra = 0.0
                if eff_obs is not None and eff_obs.slow_rank >= 0:
                    # induce the straggler inside the scope, after the
                    # card's work: the step's window stretches as a slow
                    # rank's would
                    extra = eff_obs.extra_seconds(time.perf_counter() - t_step)
                    if extra > 0:
                        time.sleep(extra)
            step_s = time.perf_counter() - t_step
            grad_norm = float(metrics["grad_norm"])
            if guards_on:
                verdict = controller.check_guards(step, loss, grad_norm)
                if verdict == "rollback":
                    raise _GuardRollback(f"guard tripped at step {step}")
                if verdict == "skip":
                    # discard the poisoned update and move on: cheaper than
                    # a rollback, at the cost of diverging from the
                    # fault-free trajectory by one skipped batch
                    state, comp_err = prev
                    del tracer.events[n_ev:]
                    step += 1
                    continue
            anchor = tracer.events[-1] if tracer.enabled else None
            if pp_info is not None and anchor is not None:
                # the train_step scope just closed; fold its wall into
                # per-(microbatch, stage, F/B) pipeline events
                emit_pipeline_events(tracer.events, pp_info.table, ts=anchor.ts,
                                     wall=anchor.dur, step_idx=step)
            if eff_obs is not None and anchor is not None:
                emit_rank_events(tracer.events, eff_obs, ts=anchor.ts,
                                 wall=anchor.dur, extra=extra, step=step)
            row = {"step": step + 1, "loss": loss, "lr": float(metrics["lr"]),
                   "grad_norm": grad_norm, "step_s": step_s,
                   "tokens_per_s": tokens_per_step / max(step_s, 1e-9)}
            history.append(row)
            if registry is not None:
                _publish_step_metrics(registry, row, tokens=tokens_per_step,
                                      flops=flops, device=dev)
                if comp is not None:
                    registry.counter("ft.wire_bytes_compressed").inc(comp_wire[0])
                    registry.counter("ft.wire_bytes_baseline").inc(comp_wire[1])
            if hooks is not None and hooks.on_step is not None:
                hooks.on_step(tracer.events[n_ev:], metrics)
            if lead and ((step + 1) % max(loop.log_every, 1) == 0
                         or step == loop.n_steps - 1):
                log.info("step %d: loss=%.4f lr=%.2e", step + 1, loss, row["lr"])
            step += 1
            if loop.ckpt_dir and step % loop.ckpt_every == 0:
                save(state, step)
        except Exception as e:  # noqa: BLE001 — the supervised recovery path
            attempts += 1
            recover = (controller is not None and bool(loop.ckpt_dir)
                       and attempts <= max_restarts
                       and not isinstance(e, NotImplementedError))
            if par_info is not None:
                recover = recover and isinstance(
                    e, (InjectedCrash, _GuardRollback, _MitigationRestart))
            if not recover:
                raise
            log.warning("step %d failed (%s: %s); recovery %d/%d",
                        step, type(e).__name__, e, attempts, max_restarts)
            if ckpt:
                # drain (not wait): a background save error here must not
                # mask the failure being recovered from
                bg = ckpt.drain()
                if bg is not None:
                    log.warning("background checkpoint save failed (%s); "
                                "restoring from the previous one", bg)
            if par_info is not None:
                dist.barrier()  # rank 0's save is on disk for every rank
            last = latest_step(loop.ckpt_dir)
            if last is None:
                raise
            if backoff_s > 0:
                time.sleep(min(backoff_s * 2 ** (attempts - 1), 30.0))
            # every leaf comes from the checkpoint; the live state only
            # gives the tree (or, for a rank's part, the whole state does)
            if par_info is not None and (par_info.layout is not None
                                         or par_info.plan.tp > 1):
                state = None
                state, _ = restore(loop.ckpt_dir, init_train_state(
                    cfg, seed=loop.seed, device=dev))
                state = par_info.shard_state(state)
            else:
                state, _ = restore(loop.ckpt_dir, state)
            if comp is not None:
                # error-feedback buffers are step-local state, not part of
                # the checkpoint contract: restart them at zero
                comp_err = comp.init(state.master)
            # drop history rows past the restored step — the replayed steps
            # re-append them; keeping both double-counts
            history[:] = [h for h in history if h["step"] <= last]
            if isinstance(e, _GuardRollback):
                controller.record_rollback(step, last)
            else:
                reason = ("exclude" if isinstance(e, _MitigationRestart)
                          else type(e).__name__)
                controller.record_restart(step, last, reason)
            if lead:
                log.info("restored checkpoint at step %d; resuming", last)
            step = last
    if ckpt:
        ckpt.wait()
    return state, history

