"""Session: the one runtime object behind every ``python -m repro_torch``
workload, counterpart of ``repro.app.session``.

A Session owns the pieces every entry point shares:

* the **model config** (``get_config(arch, smoke=...)``, or one given),
* the **device** (``runtime.device``: the card unless ``cpu`` is asked),
* the **module plugins** (MegaScan, the metrics registry, MegaScope,
  MegaFBD and MegaDPP), each attached through the uniform
  :class:`repro_torch.app.plugins.ModulePlugin` surface,
* the shared **trace export** (``run_cfg.trace_out``: a chrome trace, or
  the JSONL stream for a ``.jsonl`` path) for every workload.

Workloads: ``train`` (the train loop on one device; with ``parallel.pp >
1`` through MegaDPP's pipeline, every stage on that device, MegaFBD's
decoupled backward attached by ``parallel.fbd_backward``), ``serve``
(MegaServe continuous batching, every single-engine path and MegaScope
probes included, behind MegaRoute's router for several replicas, a
disaggregated fleet, SLO admission or a placement policy, under Poisson,
bursty or diurnal traffic; or the static lockstep baseline), ``trace``
(offline MegaScan: simulate/load -> align -> detect, host only).  What the
port does not run yet raises ``NotImplementedError`` naming its ROADMAP
item: meshes, data and tensor parallelism (item 8b), the compile cache
(item 12b), online detection and rank events (item 9) and ``dryrun`` (item
14b).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.app.config import RunConfig
from repro_torch.app.plugins import ModulePlugin, build_plugins
from repro_torch.models.hooks import NULL_COLLECTOR

log = logging.getLogger("repro_torch.app")


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is ported in a later slice (ROADMAP queue 1, {item})")


class Session:
    """One configured run: plugins + device + config, with a uniform
    lifecycle.  ``run()`` dispatches on ``run_cfg.workload``, then
    finalizes every plugin (reports land in ``session.results``) and exports
    the trace when ``run_cfg.trace_out`` is set."""

    def __init__(
        self,
        run_cfg: RunConfig,
        plugins: list[ModulePlugin] | None = None,
        *,
        model_cfg=None,
    ):
        from repro_torch.core.tracing.tracer import Tracer

        self.run_cfg = run_cfg
        # an explicit ModelConfig (e.g. a depth cut) wins over the registry
        self.model_cfg = model_cfg
        if model_cfg is None and run_cfg.arch:
            from repro_torch.configs import get_config

            self.model_cfg = get_config(run_cfg.arch, smoke=run_cfg.smoke)
        if run_cfg.runtime.compile_cache:
            raise _later("the persistent compile cache (--compile-cache)",
                         "item 12b")
        # resolved (and checked for a card) when a workload runs on it; the
        # trace workload runs on the host only
        self.device = torch.device(run_cfg.runtime.device)
        # plugin-claimable resources, with inert defaults: no scan plugin ->
        # disabled tracer, no scope plugin -> null collector, no metrics
        # plugin -> no registry (the loops then publish nothing)
        self.tracer = Tracer(rank=0, enabled=False)
        self.collector = NULL_COLLECTOR
        self.metrics_registry = None
        self.results: dict[str, Any] = {}
        self.plugins = (
            plugins if plugins is not None
            else build_plugins(run_cfg.modules, run_cfg)
        )
        for p in self.plugins:
            p.setup(self)
        self._finalized = False

    # ------------------------------------------------------------ plumbing
    def wrap_step(self, step_fn: Callable) -> Callable:
        for p in self.plugins:
            step_fn = p.wrap_step(step_fn)
        return step_fn

    def notify_step(self, events, metrics) -> None:
        for p in self.plugins:
            p.on_step(self, events, metrics)

    def step_hooks(self):
        from repro_torch.train.loop import StepHooks

        return StepHooks(wrap_step=self.wrap_step, on_step=self.notify_step)

    def finalize(self) -> dict[str, Any]:
        """Run every plugin's finalize once; export the shared trace."""
        if self._finalized:
            return self.results
        self._finalized = True
        for p in self.plugins:
            self.results[p.name] = p.finalize(self)
        if self.run_cfg.trace_out:
            # an explicit --trace-out always writes, even when the run
            # traced nothing (--modules none): an empty trace file is
            # debuggable, a silently missing one is not
            if not self.tracer.events:
                log.warning(
                    "trace_out=%s: no TraceEvents were recorded (is the "
                    "'scan' module enabled?)", self.run_cfg.trace_out)
            out_path = Path(self.run_cfg.trace_out)
            streamed = self.results.get("scan", {}).get("stream", "")
            if out_path.suffix == ".jsonl":
                # the scan plugin already streamed it; dump at the end only
                # when no plugin streamed (--modules none)
                if str(out_path) != streamed:
                    with open(out_path, "w") as f:
                        for e in self.tracer.events:
                            f.write(json.dumps(e.to_json()) + "\n")
            else:
                from repro_torch.core.tracing.chrome import save_chrome

                save_chrome(self.tracer.events, self.run_cfg.trace_out)
            self.results["trace_out"] = self.run_cfg.trace_out
            log.info("trace -> %s", self.run_cfg.trace_out)
        return self.results

    # ----------------------------------------------------------- dispatch
    def run(self):
        """Run the configured workload, then finalize plugins."""
        fn = {
            "train": self.train,
            "serve": self.serve,
            "trace": self.trace,
            "dryrun": self.dryrun,
        }[self.run_cfg.workload]
        try:
            return fn()
        finally:
            self.finalize()

    # -------------------------------------------------------------- train
    def _train_derived(self):
        """Resolve the 0-means-auto training fields against smoke/full."""
        rc, t = self.run_cfg, self.run_cfg.train
        seq = t.seq_len or (128 if rc.smoke else 4096)
        batch = t.global_batch or (8 if rc.smoke else 256)
        # minicpm trains with WSD per its paper (kept from the JAX launcher)
        schedule = t.schedule
        if self.model_cfg.name.startswith("minicpm") and schedule == "cosine":
            schedule = "wsd"
        return seq, batch, schedule

    def _refuse_train_plumbing(self) -> None:
        rc = self.run_cfg
        par = rc.parallel
        if rc.mesh not in ("auto", "host"):
            raise _later(f"mesh {rc.mesh!r}", "item 8b")
        if par.dp > 1 or par.tp > 1:
            raise _later(
                f"data and tensor parallelism (dp={par.dp}, tp={par.tp})",
                "item 8b")
        if par.fbd_backward and par.pp <= 1:
            # as in JAX, where the plan is None at pp = 1 and the decoupled
            # backward attaches only to the pipeline step (ROADMAP R5)
            log.info("parallel.fbd_backward: the decoupled backward attaches "
                     "to the pipeline step (pp > 1); at pp=1 it changes "
                     "nothing")
        if rc.obs.rank_events or rc.obs.slow_rank >= 0:
            raise _later("per-rank event synthesis (obs.rank_events, "
                         "obs.slow_rank)", "item 9")

    def parallel_plan(self):
        """Resolve the ``parallel`` section into a ``ParallelPlan`` (pp > 1)
        or ``None`` (the plain step).  Wave resolution — ``schedule=wave``
        with ``wave=0`` — runs MegaDPP's planner under the ``dpp`` section's
        memory cap."""
        par = self.run_cfg.parallel
        if par.pp <= 1:
            return None
        from repro_torch.parallel.plan import ParallelPlan, resolve_plan

        return resolve_plan(
            ParallelPlan(
                dp=par.dp, tp=par.tp, pp=par.pp,
                n_micro=par.n_micro, n_chunks=par.n_chunks,
                schedule=par.schedule, wave=par.wave,
                fbd_backward=par.fbd_backward,
            ),
            memory_cap_gib=self.run_cfg.dpp.memory_cap_gib,
        )

    def train(self):
        """The training workload: returns ``(state, history)``."""
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.train.loop import LoopConfig, refuse_embeds, train
        from repro_torch.train.optim import OptimizerConfig

        rc, t = self.run_cfg, self.run_cfg.train
        cfg = self.model_cfg
        if cfg is None:
            raise ValueError("train workload needs an --arch")
        refuse_embeds(cfg)
        self._refuse_train_plumbing()
        seq, batch, schedule = self._train_derived()
        if batch % max(t.grad_accum, 1):
            raise ValueError(f"global batch {batch} not divisible by "
                             f"train.grad_accum={t.grad_accum}")
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch)
        ocfg = OptimizerConfig(
            lr=t.lr, schedule=schedule,
            warmup_steps=t.warmup_steps or max(t.steps // 10, 5),
            total_steps=t.steps,
        )
        loop = LoopConfig(
            n_steps=t.steps,
            log_every=t.log_every or max(t.steps // 10, 1),
            ckpt_dir=t.ckpt_dir or None,
            ckpt_every=t.ckpt_every,
            grad_accum=t.grad_accum,
            seed=rc.seed,
        )
        plan = self.parallel_plan()
        if plan is not None:
            from repro_torch.core.dpp.executor import make_pipeline_stages
            from repro_torch.parallel.plan import plan_summary

            # per-axis divisibility: the batch first splits into grad_accum
            # macrobatches, each macrobatch into n_micro microbatches
            ga = max(1, loop.grad_accum)
            if (batch // ga) % plan.n_micro != 0:
                raise ValueError(
                    f"per-accumulation batch {batch // ga} (global {batch} "
                    f"/ grad_accum {ga}) not divisible by "
                    f"parallel.n_micro={plan.n_micro}"
                )
            stages = make_pipeline_stages(plan.pp, self.device)
            self.results["parallel"] = {
                **plan_summary(plan), "stages": [str(d) for d in stages],
            }
        log.info("arch=%s device=%s tokens/step=%d", cfg.name, self.device,
                 batch * seq)
        state, history = train(
            cfg, ocfg, data, loop, collector=self.collector, tracer=self.tracer,
            hooks=self.step_hooks(), registry=self.metrics_registry,
            device=self.device, plan=plan,
        )
        self.results["train_config"] = {
            "seq_len": seq, "global_batch": batch, "grad_accum": t.grad_accum,
            "steps": t.steps,
        }
        self.results["history"] = history
        return state, history

    # -------------------------------------------------------------- serve
    def serve(self):
        """The serving workload: returns ``(outputs, metrics)``.

        ``serve.continuous`` drives MegaServe (paged KV cache, scheduler,
        optional chunked prefill and speculation, MegaScope captures);
        otherwise the static lockstep baseline runs."""
        cfg = self.model_cfg
        if cfg is None:
            raise ValueError("serve workload needs an --arch")
        s = self.run_cfg.serve
        if s.continuous:
            if cfg.input_kind != "tokens":
                raise ValueError(f"{cfg.name}: continuous serving needs token archs")
            if s.temperature != 0.0:
                raise ValueError(
                    "continuous serving decodes greedily "
                    "(preemption-by-recompute needs deterministic decode)")
            return self._serve_continuous()
        if cfg.input_kind != "tokens" and cfg.family != "encdec":
            raise ValueError(f"{cfg.name} needs a modality frontend; serve token archs")
        return self._serve_static()

    def _serve_continuous(self):
        from dataclasses import replace

        from repro_torch.device import resolve_device
        from repro_torch.models import lm
        from repro_torch.serve.router import Router, RouterConfig
        from repro_torch.serve.server import MegaServe, make_poisson_workload
        from repro_torch.serve.spec import get_drafter

        cfg, rc, s = self.model_cfg, self.run_cfg, self.run_cfg.serve
        r = rc.router
        # always build the RouterConfig, so bad router.* values fail loudly
        # even on single-engine runs
        router_cfg = RouterConfig(
            replicas=r.replicas, policy=r.policy,
            prefill_replicas=r.prefill_replicas,
            slo_ttft_s=r.slo_ttft_s, shed=r.shed,
        )
        use_router = (
            router_cfg.replicas > 1
            or router_cfg.disaggregated
            or router_cfg.slo_ttft_s > 0
            or router_cfg.policy != "round_robin"
        )
        # drawn in the compute dtype leaf by leaf (the values the server's
        # cast would give), so no float32 tree sits beside the cast: at
        # deepseek-v2-lite's 15.7 B parameters the two would not fit a card
        params = lm.init(cfg, seed=rc.seed, device=resolve_device(self.device),
                         dtype=getattr(torch, cfg.compute_dtype))
        specs, prompts, serve_cfg = make_poisson_workload(
            cfg, n=s.requests, rate=s.rate, prompt_lens=tuple(s.prompt_lens),
            max_new_range=(max(1, s.max_new // 4), s.max_new),
            num_slots=s.slots, block_size=s.block_size,
            num_blocks=s.num_blocks, seed=rc.seed, traffic=s.traffic,
        )
        serve_cfg = replace(
            serve_cfg, decode_path=s.decode_path,
            prefill_path=s.prefill_path,
            spec_decode=s.spec_decode, spec_k=s.spec_k,
            chunked_prefill=s.chunked_prefill, chunk_len=s.chunk_len,
        )
        drafter = None
        if s.spec_decode and s.drafter != "ngram":
            drafter = get_drafter(s.drafter, vocab_size=cfg.vocab_size,
                                  seed=rc.seed)
        if use_router:
            # the router casts the weights once; its replicas share them
            srv = Router.from_session(
                self, params, serve_cfg, router_cfg, drafter=drafter)
            replica_streams = [rep.streams for rep in srv.replicas]
            engine = srv.replicas[0]
        else:
            srv = MegaServe.from_session(self, params, serve_cfg, drafter=drafter)
            replica_streams = [srv.streams]
            engine = srv
        del params  # the servers hold the compute-dtype copy
        for spec in specs:
            srv.submit(prompts[spec.rid], spec.max_new, arrival=spec.arrival)
        outs = srv.drain(on_step=self.notify_step)
        metrics = srv.metrics()
        if use_router:
            # replica lanes trace on their own rank=i tracers and the router
            # on rank=N: fold them into the session tracer, so the shared
            # trace_out export shows every lane
            self.tracer.events.extend(srv.trace_events())
        self.results["serve_config"] = {
            "num_slots": serve_cfg.num_slots,
            "block_size": serve_cfg.block_size,
            "num_blocks": serve_cfg.num_blocks,
            "replicas": router_cfg.replicas if use_router else 1,
            "policy": router_cfg.policy if use_router else "",
            "traffic": s.traffic,
        }
        # MegaServe attaches probe captures per generated token (StreamItem),
        # not per tick: replay them through on_step so capture-observing
        # plugins (MegaScope) see serving captures as they see training ones
        if self.collector is not NULL_COLLECTOR:
            for streams in replica_streams:
                for items in streams.values():
                    for it in items:
                        if it.captures:
                            self.notify_step([], {"captures": it.captures})
        self.results["serve_metrics"] = metrics
        self.results["decode_path"] = engine.decode_path
        self.results["prefill_path"] = engine.prefill_path
        self.results["stream_items"] = {
            rid: items for streams in replica_streams
            for rid, items in streams.items()}
        return outs, metrics

    def _serve_static(self):
        """Static lockstep serving (JAX ``_serve_static``): ``serve.batch``
        random prompts of ``serve.prompt_len`` tokens (numpy, from the run's
        seed) prefilled together over a dense cache, then ``max_new - 1``
        lockstep decode steps.  The encoder-decoder also takes ``[B, P,
        d_model]`` source frames, N(0, 1) drawn from the same generator
        after the prompts and rounded to the compute dtype, so its cache's
        ``src_len`` is ``prompt_len``.  Greedy whatever ``--temperature``
        says, as the JAX package's keyless ``sample`` is (ROADMAP R7).
        Returns ``(tokens [B, max_new] as lists, metrics)``; the prompts land
        in ``results["static_prompts"]``."""
        from repro_torch.device import resolve_device
        from repro_torch.models.model import get_model
        from repro_torch.serve.engine import make_decode_step, make_prefill_step
        from repro_torch.serve.sampler import sample

        cfg, rc, s = self.model_cfg, self.run_cfg, self.run_cfg.serve
        dev = resolve_device(self.device)
        dtype = getattr(torch, cfg.compute_dtype)
        m = get_model(cfg)
        params = m.init(cfg, seed=rc.seed, device=dev, dtype=dtype)
        B, P = s.batch, s.prompt_len
        encdec = cfg.family == "encdec"
        cache = (m.init_cache(cfg, B, P + s.max_new, P, device=dev) if encdec
                 else m.init_cache(cfg, B, P + s.max_new, device=dev))
        rng = np.random.default_rng(rc.seed)
        prompts = rng.integers(2, cfg.vocab_size, size=(B, P))
        batch = {"tokens": torch.as_tensor(prompts, device=dev)}
        if encdec:
            batch["embeds"] = torch.from_numpy(
                rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
            ).to(dev, dtype)
        prefill = self.wrap_step(make_prefill_step(cfg, self.collector))
        decode = self.wrap_step(make_decode_step(
            cfg, self.collector, temperature=s.temperature))

        t0 = time.perf_counter()
        n_ev = len(self.tracer.events)
        with self.tracer.scope("prefill", kind="compute", tokens=B * P, batch=B):
            logits, _ = prefill(params, batch, cache)
            tok = sample(logits, temperature=s.temperature)
            outs = [tok.tolist()]  # reads back: ends device work
        t_prefill = time.perf_counter() - t0
        self.notify_step(self.tracer.events[n_ev:], {})

        t0 = time.perf_counter()
        for i in range(s.max_new - 1):
            n_ev = len(self.tracer.events)
            with self.tracer.scope("decode", kind="compute", step=i, active=B,
                                   tokens=B):
                _, tok, _ = decode(params, cache, tok, P + i)
                outs.append(tok.tolist())
            self.notify_step(self.tracer.events[n_ev:], {})
        t_decode = time.perf_counter() - t0

        gen = [list(row) for row in zip(*outs)]
        metrics = {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "prefill_tok_s": B * P / max(t_prefill, 1e-9),
            "decode_tok_s": B * (s.max_new - 1) / max(t_decode, 1e-9),
        }
        if self.metrics_registry is not None:
            reg = self.metrics_registry
            reg.histogram("serve.prefill_s").observe(t_prefill)
            reg.counter("serve.tokens").inc(B * s.max_new)
            reg.gauge("serve.decode_tok_s").set(metrics["decode_tok_s"])
        self.results["serve_metrics"] = metrics
        self.results["static_prompts"] = prompts.tolist()
        return gen, metrics

    # -------------------------------------------------------------- trace
    def trace(self):
        """Offline MegaScan: simulate (or load) -> align -> detect.

        Returns the :class:`repro_torch.core.tracing.detect.Diagnosis`; its
        summary (plus ground truth, when simulated) lands in
        ``results["diagnosis"]`` and the aligned events are exported via
        the shared ``trace_out`` / ``trace.out`` paths.
        """
        from repro_torch.core.simkit.engine import FaultModel
        from repro_torch.core.simkit.workload import ModelProfile, Topology
        from repro_torch.core.tracing import (
            ClockModel,
            align_clocks,
            apply_alignment,
            detect,
            simulate_trace,
        )
        from repro_torch.core.tracing.chrome import save_chrome
        from repro_torch.core.tracing.tracer import load_jsonl, load_trace

        t = self.run_cfg.trace
        topo = Topology(dp=t.dp, pp=t.pp, tp=t.tp)
        truth = None
        if t.detect:
            # offline triage of a saved run: chrome JSON or streamed JSONL
            events = load_trace(t.detect)
        elif t.load:
            events = load_jsonl(t.load)
        else:
            faults = FaultModel(
                compute_slowdown={t.slow_rank: t.slow_factor},
                jitter=0.01, seed=self.run_cfg.seed,
            )
            events, truth = simulate_trace(
                topo, ModelProfile(), n_micro=t.n_micro, n_iters=t.n_iters,
                faults=faults, clocks=ClockModel(seed=self.run_cfg.seed),
            )
        sc = self.run_cfg.scan
        aligned = apply_alignment(events, align_clocks(events))
        diag = detect(
            aligned, topo,
            slow_ratio=sc.slow_ratio, candidate_frac=sc.candidate_frac,
            skew_margin=sc.skew_margin, late_frac=sc.late_frac,
            degrade_ratio=sc.degrade_ratio,
        )
        self.results["diagnosis"] = diag.summary()
        if truth is not None:
            self.results["truth"] = {
                "slow_ranks": truth["slow_ranks"],
                "detected": diag.slow_ranks == truth["slow_ranks"],
            }
        # aligned events flow through the session tracer so the shared
        # trace_out export (Session.finalize) sees them like any workload
        self.tracer.enabled = True
        self.tracer.events.extend(aligned)
        if t.out:
            out = Path(t.out)
            out.mkdir(parents=True, exist_ok=True)
            save_chrome(aligned, out / "trace.json")
            (out / "diagnosis.json").write_text(
                json.dumps(diag.summary(), indent=1))
            self.results["out"] = str(out)
        return diag

    # ------------------------------------------------------------- dryrun
    def dryrun(self):
        raise _later("the dryrun workload (FLOP and memory estimates per "
                     "cell)", "item 14b")
