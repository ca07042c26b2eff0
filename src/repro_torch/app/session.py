"""Session: the one runtime object behind every ``python -m repro_torch``
workload, counterpart of ``repro.app.session``.

A Session owns the pieces every entry point shares:

* the **model config** (``get_config(arch, smoke=...)``, or one given),
* the **device** (``runtime.device``: the card unless ``cpu`` is asked),
* the **module plugins** (MegaScan, the metrics registry, MegaScope,
  MegaFBD, MegaDPP and MegaFT), each attached through the uniform
  :class:`repro_torch.app.plugins.ModulePlugin` surface,
* the shared **trace export** (``run_cfg.trace_out``: a chrome trace, or
  the JSONL stream for a ``.jsonl`` path) for every workload.

Workloads: ``train`` (the train loop; with ``parallel.pp``, ``dp`` or
``tp`` > 1 in a world of ``pp * dp * tp`` ranks, spawned here unless this
process already joined one (``torchrun``): the batch split over ``data``,
Megatron's tensor split over ``model``, each MegaDPP pipeline stage a
process, MegaFBD's decoupled backward on the next stage's process under
``parallel.fbd_backward``), ``serve``
(MegaServe continuous batching, every single-engine path and MegaScope
probes included, behind MegaRoute's router for several replicas, a
disaggregated fleet, SLO admission or a placement policy, under Poisson,
bursty or diurnal traffic; or the static lockstep baseline), ``trace``
(offline MegaScan: simulate/load -> align -> detect, host only) and
``dryrun`` (FLOP and memory estimates per (arch, shape) cell on the meta
device, ``launch.dryrun``).  The ``ft`` plugin's controller supervises the
train loop, and the ``scan`` plugin's online detector feeds it through
``notify_detection``; in a world of ranks both act from rank 0.
``runtime.compile_cache`` names the persistent compile cache the train
loop and the serving engines build their kernels through; a server with
one precompiles its bucket ladders before the first request.  What the
port does not run yet (the rest of the sharding, ROADMAP item 8c) raises
``NotImplementedError`` naming its item.
"""

from __future__ import annotations

import copy
import json
import logging
import os
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


def pick_mesh(spec: str):
    """Shared mesh selection over the ranks of this process's world, JAX's
    ``pick_mesh``: ``auto`` picks the production mesh when the world holds
    its 256 ranks, else a host mesh; ``host`` / ``pod1`` / ``pod2`` force a
    shape; ``auto-mp`` asks for the two-pod shape (JAX's forces host
    devices to fall back on; a world cannot grow to it, so a smaller one
    raises).  A mesh larger than the world raises a ``ValueError`` naming
    both counts; a world of one rank with no process group has no host
    mesh (None)."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.parallel.dist import world_size

    if spec == "host":
        return make_host_mesh()
    if spec == "pod1":
        return make_production_mesh(multi_pod=False)
    if spec in ("pod2", "auto-mp"):
        return make_production_mesh(multi_pod=True)
    if spec == "auto":
        if world_size() >= 256:
            return make_production_mesh(multi_pod=False)
        return make_host_mesh()
    raise ValueError(f"unknown mesh spec {spec!r}")


def _rank_main(run_cfg: RunConfig, model_cfg) -> dict:
    """One rank of a spawned world: the Session run in place.  Rank 0 hands
    back its workload's history, results and trace events; every rank its
    device and mesh coordinates."""
    from repro_torch.parallel.dist import world

    session = Session(run_cfg, model_cfg=model_cfg)
    _, history = session.run()
    w = world()
    info = {"rank": w.rank, "device": str(w.device),
            "coords": session.results["parallel"]["coords"]}
    if w.rank:
        return {"rank": info}
    results = {k: v for k, v in session.results.items() if k != "history"}
    return {"rank": info, "history": history, "results": results,
            "events": session.tracer.events}


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
        from repro_torch.parallel import dist as pdist

        #: this process's rank in its world (0 outside one); a torchrun
        #: rank knows it before it joins
        self.rank = (pdist.world().rank if pdist.world() is not None else
                     int(os.environ["RANK"]) if pdist.under_torchrun() else 0)
        if self.rank:
            # in a world, rank 0 alone writes the run's files
            run_cfg = copy.deepcopy(run_cfg)
            run_cfg.trace_out = run_cfg.obs.metrics_out = run_cfg.obs.prom_out = ""
        self.run_cfg = run_cfg
        # an explicit ModelConfig (e.g. a depth cut) wins over the registry
        self.model_cfg = model_cfg
        if model_cfg is None and run_cfg.arch:
            from repro_torch.configs import get_config

            self.model_cfg = get_config(run_cfg.arch, smoke=run_cfg.smoke)
        # runtime.compile_cache -> the persistent build cache shared by the
        # train loop's warm-up and the serving engines' precompile ladders
        self.compile_cache = None
        if run_cfg.runtime.compile_cache:
            from repro_torch.core.compile_cache import CompileCache

            self.compile_cache = CompileCache(run_cfg.runtime.compile_cache)
        # resolved (and checked for a card) when a workload runs on it; the
        # trace workload runs on the host only
        self.device = torch.device(run_cfg.runtime.device)
        par = run_cfg.parallel
        self.world_size = (par.pp * par.dp * par.tp
                           if run_cfg.workload == "train" else 1)
        # this Session spawns the world's ranks and runs in none of them
        # (a rank's own Session does the work and sets up its plugins)
        self.spawns = (self.world_size > 1 and pdist.world() is None
                       and not pdist.under_torchrun())
        if pdist.world() is not None:
            self.device = pdist.world().device
        # plugin-claimable resources, with inert defaults: no scan plugin ->
        # disabled tracer, no scope plugin -> null collector, no metrics
        # plugin -> no registry (the loops then publish nothing)
        self.tracer = Tracer(rank=0, enabled=False)
        self.collector = NULL_COLLECTOR
        self.metrics_registry = None
        # no ft plugin -> no controller (the train loop runs unsupervised);
        # detection listeners receive every online DetectionUpdate the scan
        # plugin's detector produces
        self.ft_controller = None
        self.detection_listeners: list[Callable] = []
        self.results: dict[str, Any] = {}
        self.plugins = (
            [] if self.spawns else plugins if plugins is not None
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

    def notify_detection(self, update) -> None:
        """Fan one online ``DetectionUpdate`` out to detection listeners
        (the ft controller registers here) — called by the scan plugin."""
        for listener in self.detection_listeners:
            listener(update)

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
        """Run the configured workload, then finalize plugins.  A Session
        that spawns its world runs the workload on its ranks and takes rank
        0's results, trace events and history (``(None, history)``: the
        state stays with the ranks), and every rank's device and
        coordinates under ``results["parallel"]["ranks"]``."""
        from repro_torch.parallel import dist as pdist

        if pdist.world() is None and pdist.under_torchrun() and self.world_size > 1:
            pdist.join_from_env(self.run_cfg.runtime.device)
            self.device = pdist.world().device
        if self.spawns:
            self._train_checks()
            ranks = pdist.spawn(_rank_main, (self.run_cfg, self.model_cfg),
                                self.world_size, device=self.run_cfg.runtime.device)
            self._finalized = True
            self.results = ranks[0]["results"]
            self.results["parallel"]["ranks"] = [r["rank"] for r in ranks]
            self.results["history"] = ranks[0]["history"]
            self.tracer.events = ranks[0]["events"]
            return None, ranks[0]["history"]
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
            # a production mesh needs its ranks: smaller worlds raise here
            pick_mesh(rc.mesh)
        if par.fbd_backward and par.pp <= 1:
            # as in JAX, where the plan is None at pp = 1 and the decoupled
            # backward attaches only to the pipeline step (ROADMAP R5)
            log.info("parallel.fbd_backward: the decoupled backward attaches "
                     "to the pipeline step (pp > 1); at pp=1 it changes "
                     "nothing")
        if "ft" in rc.modules:
            from repro_torch.app.plugins import chaos_spec

            chaos_spec(rc)  # its checks, before a world's ranks start

    def _rank_event_spec(self, plan=None):
        """Resolve the ``obs`` section into a per-rank event synthesis spec
        (``None`` unless rank events or straggler induction are asked for),
        as the JAX session does.  With a ``ParallelPlan`` the synthesized
        topology follows the plan's (dp, pp, tp), so detector rank
        coordinates and the ft mitigation's link-axis routing agree with
        the ranks actually training; the ``obs`` section's dims apply to
        plan-less runs only."""
        o = self.run_cfg.obs
        ch = self.run_cfg.ft.chaos
        chaos_needs = self.ft_controller is not None and (
            ch.slow_rank_from >= 0 or bool(ch.degrade_link))
        if not (o.rank_events or o.slow_rank >= 0 or chaos_needs):
            return None
        from repro_torch.obs import RankEventSpec

        dims = ({"dp": plan.dp, "pp": plan.pp, "tp": plan.tp} if plan is not None
                else {"dp": o.dp, "pp": o.pp, "tp": o.tp})
        return RankEventSpec(**dims, slow_rank=o.slow_rank,
                             slow_factor=o.slow_factor)

    def parallel_plan(self):
        """Resolve the ``parallel`` section into a ``ParallelPlan`` (pp, dp
        or tp > 1) or ``None`` (the plain step).  Wave resolution —
        ``schedule=wave`` with ``wave=0`` — runs MegaDPP's planner under the
        ``dpp`` section's memory cap."""
        par = self.run_cfg.parallel
        if par.pp <= 1 and par.dp <= 1 and par.tp <= 1:
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

    def _train_checks(self):
        """The train workload's configuration checks, made before any rank
        starts: ``(seq, batch, schedule, plan)``."""
        from repro_torch.train.loop import refuse_embeds

        t = self.run_cfg.train
        cfg = self.model_cfg
        if cfg is None:
            raise ValueError("train workload needs an --arch")
        refuse_embeds(cfg)
        self._refuse_train_plumbing()
        seq, batch, schedule = self._train_derived()
        if batch % max(t.grad_accum, 1):
            raise ValueError(f"global batch {batch} not divisible by "
                             f"train.grad_accum={t.grad_accum}")
        plan = self.parallel_plan()
        if plan is not None:
            ga = max(1, t.grad_accum)
            # per-axis divisibility: the batch first splits into grad_accum
            # macrobatches, each macrobatch into n_micro microbatches (pp >
            # 1) or into dp shards
            if plan.pp > 1 and (batch // ga) % plan.n_micro != 0:
                raise ValueError(
                    f"per-accumulation batch {batch // ga} (global {batch} "
                    f"/ grad_accum {ga}) not divisible by "
                    f"parallel.n_micro={plan.n_micro}"
                )
            if (batch // ga) % plan.dp != 0:
                raise ValueError(
                    f"per-accumulation batch {batch // ga} (global {batch} "
                    f"/ grad_accum {ga}) not divisible by parallel.dp={plan.dp}")
            if plan.pp > 1 or plan.tp > 1:
                from repro_torch.models.pipeline import pipeline_layout

                if plan.pp == 1 and plan.tp > 1:
                    from repro_torch.train.train_step import _dense_gqa

                    if not _dense_gqa(cfg):
                        raise _later(f"{cfg.name}: tensor parallelism at pp=1 "
                                     "over other than dense GQA blocks", "item 8c")
                pipeline_layout(cfg, plan.pp, plan.n_chunks if plan.pp > 1 else 1,
                                tp=plan.tp)
        return seq, batch, schedule, plan

    def train(self):
        """The training workload: returns ``(state, history)``."""
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.train.loop import LoopConfig, train
        from repro_torch.train.optim import OptimizerConfig

        rc, t = self.run_cfg, self.run_cfg.train
        cfg = self.model_cfg
        seq, batch, schedule, plan = self._train_checks()
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
        mesh = None
        if plan is not None:
            from repro_torch.core.dpp.executor import make_pipeline_stages
            from repro_torch.launch.mesh import make_pipeline_mesh, mesh_axes
            from repro_torch.parallel import dist as pdist
            from repro_torch.parallel.plan import plan_summary

            # a plan runs in its world: run() spawned it or joined torchrun's
            w = pdist.world()
            if w is None or w.size != plan.world:
                raise ValueError(f"a pp={plan.pp} x dp={plan.dp} x tp={plan.tp} "
                                 f"plan needs {plan.world} ranks, the world "
                                 f"has {pdist.world_size()}")
            mesh = make_pipeline_mesh(plan.pp, plan.dp, plan.tp)
            coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
            stages = (make_pipeline_stages(plan.pp, mesh=mesh) if plan.pp > 1
                      else [w.rank])
            log.info("rank %d of %d: %s", w.rank, w.size, coords)
            self.results["parallel"] = {
                **plan_summary(plan), "stages": stages,
                "mesh": mesh_axes(mesh), "coords": coords, "backend": w.backend,
            }
        log.info("arch=%s device=%s tokens/step=%d", cfg.name, self.device,
                 batch * seq)
        state, history = train(
            cfg, ocfg, data, loop, collector=self.collector, tracer=self.tracer,
            hooks=self.step_hooks(), registry=self.metrics_registry,
            device=self.device, plan=plan, mesh=mesh,
            obs=self._rank_event_spec(plan), controller=self.ft_controller,
            compile_cache=self.compile_cache,
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
        if self.compile_cache is not None:
            # warm every bucket ladder up front: with a populated cache the
            # kernels load instead of building, so restart-to-first-token is
            # the weights' and the warm-up steps'
            self.results["precompile"] = srv.precompile()
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
        """FLOP and memory estimates per (arch, shape) cell on the meta
        device (``repro_torch.launch.dryrun.run_cells``): ``{tag: result or
        {"error": ...}}``."""
        from repro_torch.launch.dryrun import run_cells

        d = self.run_cfg.dryrun
        result = run_cells(
            arch=self.run_cfg.arch or None,
            shape=d.shape or None,
            run_all=d.all,
            multi_pod=d.multi_pod,
            profile=d.profile or None,
            grad_accum=d.grad_accum,
            out=d.out,
            save_hlo=d.save_hlo,
            smoke=self.run_cfg.smoke,
            host_mesh=d.host_mesh,
        )
        self.results["dryrun"] = result
        return result
