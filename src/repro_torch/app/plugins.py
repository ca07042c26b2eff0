"""ModulePlugin protocol, counterpart of ``repro.app.plugins``: the
MegatronApp modules as uniform plugins of a :class:`~repro_torch.app.session.Session`.

Every module attaches through the same four hooks:

* ``setup(session)``    — claim resources on the session (tracer, registry)
  before the workload builds anything;
* ``wrap_step(fn)``     — decorate the workload's step callable;
* ``on_step(session, events, metrics)`` — observe one workload step: the
  MegaScan ``TraceEvent``s it emitted and its metrics dict;
* ``finalize(session)`` — return a JSON-able report (merged into
  ``session.results``) and release anything held.

The port runs every module of the JAX package: MegaScan (``scan``, with
the online straggler detector under ``--detect-online``), the metrics
registry (``metrics``), MegaScope (``scope``), MegaFBD (``fbd``), MegaDPP
(``dpp``) and MegaFT (``ft``).
"""

from __future__ import annotations

from pathlib import Path

PLUGIN_REGISTRY: dict[str, type["ModulePlugin"]] = {}


def register_plugin(cls: type["ModulePlugin"]) -> type["ModulePlugin"]:
    """Class decorator: make a plugin selectable via ``--modules <name>``."""
    if not getattr(cls, "name", ""):
        raise ValueError(f"{cls.__name__} needs a non-empty `name`")
    PLUGIN_REGISTRY[cls.name] = cls
    return cls


class ModulePlugin:
    """Base plugin: every hook is a no-op, subclass what you need."""

    name = ""

    def __init__(self, run_cfg):
        self.run_cfg = run_cfg

    def setup(self, session) -> None:  # noqa: ARG002 - uniform signature
        return None

    def wrap_step(self, step_fn):
        return step_fn

    def on_step(self, session, events, metrics) -> None:
        return None

    def finalize(self, session) -> dict:
        return {}


def build_plugins(names, run_cfg) -> list[ModulePlugin]:
    out = []
    for n in names:
        cls = PLUGIN_REGISTRY.get(n)
        if cls is None:
            raise ValueError(f"unknown module {n!r}; registered: {sorted(PLUGIN_REGISTRY)}")
        out.append(cls(run_cfg))
    return out


# ---------------------------------------------------------------------------
# MegaScan — always-on workload tracing
# ---------------------------------------------------------------------------


@register_plugin
class ScanPlugin(ModulePlugin):
    """Owns the session Tracer; optionally synchronises the step.

    The workloads end each traced step with a read-back (the train loop's
    loss, the serving ticks' sampled tokens), so a scope covers the card's
    work.  ``--set scan.sync=true`` also wraps the step callable with
    ``torch.cuda.synchronize()`` on the card, where the JAX package calls
    ``jax.block_until_ready``.  A ``--trace-out`` path additionally streams
    every event through an ``AsyncTraceWriter`` to a ``.jsonl`` sidecar as
    the run progresses, so a mid-run crash leaves a usable trace (a
    ``.jsonl`` trace_out IS the stream — Session then skips the end-of-run
    chrome export).

    ``--detect-online`` runs a :class:`repro_torch.obs.OnlineDetector` over
    the step event stream (topology from the ``ParallelPlan`` when one
    resolves, else the ``obs`` section); every pass goes to
    ``session.notify_detection`` (the ft controller listens there), verdict
    deltas are stamped into the trace as ``diagnosis`` instant events, and
    the last diagnosis lands in the ``scan.online`` report.  In a world of
    ranks, rank 0 alone owns the detector.
    """

    name = "scan"

    def setup(self, session) -> None:
        from repro_torch.core.tracing.tracer import AsyncTraceWriter, Tracer

        sc = self._scan_cfg = self.run_cfg.scan
        session.tracer = Tracer(rank=sc.rank, enabled=True)
        self._detector = None
        self._first_detect: int | None = None
        if sc.detect_online and session.rank == 0:
            from repro_torch.core.simkit.workload import Topology
            from repro_torch.obs import OnlineDetector

            # a ParallelPlan wins over the obs section's synthetic dims:
            # detector rank coordinates must match the plan actually
            # training, or the ft mitigation routes links to the wrong axis
            plan = session.parallel_plan()
            o = self.run_cfg.obs
            topo = (plan.topology() if plan is not None
                    else Topology(dp=o.dp, pp=o.pp, tp=o.tp))
            self._detector = OnlineDetector(
                topo, every=sc.detect_every, window=sc.detect_window,
                align=sc.detect_align,
                thresholds=dict(
                    slow_ratio=sc.slow_ratio, candidate_frac=sc.candidate_frac,
                    skew_margin=sc.skew_margin, late_frac=sc.late_frac,
                    degrade_ratio=sc.degrade_ratio,
                ),
            )
        self._sync = sc.sync and session.device.type == "cuda"
        self._writer = None
        self._streamed = 0
        if self.run_cfg.trace_out:
            self._stream_path = Path(self.run_cfg.trace_out).with_suffix(".jsonl")
            self._writer = AsyncTraceWriter(self._stream_path, mode="w")

    def wrap_step(self, step_fn):
        if not self._sync:
            return step_fn
        import torch

        def synced(*a, **kw):
            out = step_fn(*a, **kw)
            torch.cuda.synchronize()
            return out

        return synced

    def _stream(self, session) -> None:
        evs = session.tracer.events
        self._writer.submit(evs[self._streamed:])
        self._streamed = len(evs)

    def on_step(self, session, events, metrics) -> None:
        if self._detector is not None and events:
            update = self._detector.push(events)
            if update is not None:
                if update.diagnosis.slow_ranks and self._first_detect is None:
                    self._first_detect = update.step
                # every completed pass flows to the detection listeners (the
                # ft controller): they decide on the full diagnosis
                session.notify_detection(update)
                if update.changed:
                    session.tracer.instant(
                        "diagnosis",
                        slow_ranks=list(update.diagnosis.slow_ranks),
                        new=update.new_slow_ranks,
                        cleared=update.cleared_slow_ranks,
                        degraded_links=[list(l) for l in update.new_degraded_links],
                    )
        if self._writer is not None:
            self._stream(session)

    def finalize(self, session) -> dict:
        by_name: dict[str, float] = {}
        for e in session.tracer.events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.dur
        out = {
            "events": len(session.tracer.events),
            "dur_s_by_name": {k: round(v, 4) for k, v in sorted(by_name.items())},
        }
        if self._writer is not None:
            self._stream(session)
            self._writer.close()
            out["stream"] = str(self._stream_path)
        if self._detector is not None:
            last = self._detector.history[-1] if self._detector.history else {}
            out["online"] = {
                "passes": len(self._detector.history),
                "first_detect_step": self._first_detect,
                "slow_ranks": last.get("slow_ranks", []),
                "degraded_links": last.get("degraded_links", []),
            }
        return out


# ---------------------------------------------------------------------------
# Live metrics — the MetricsRegistry + exporters behind every workload
# ---------------------------------------------------------------------------


@register_plugin
class MetricsPlugin(ModulePlugin):
    """Owns the session :class:`repro_torch.obs.MetricsRegistry`.

    The instrumented loops (``train.loop``, ``serve.server``) publish their
    standard series into ``session.metrics_registry``; this plugin samples
    the registry every ``obs.every`` steps — appending a flat JSONL row to
    ``--metrics-out`` (written off the step's thread) and chrome counter
    events to the session trace — and at finalize writes the
    ``obs.prom_out`` Prometheus snapshot and reports the flattened series
    (plus an MFU estimate when ``obs.peak_tflops`` is set: the median of
    ``train.model_flops_per_s`` over the peak).  It reads host values only:
    what the loops published, never the card.
    """

    name = "metrics"

    def setup(self, session) -> None:
        from repro_torch.obs import JsonlExporter, MetricsRegistry

        self._obs = self.run_cfg.obs
        self.registry = MetricsRegistry()
        session.metrics_registry = self.registry
        self._jsonl = (
            JsonlExporter(self._obs.metrics_out)
            if self._obs.metrics_out else None
        )
        self._n = 0

    def on_step(self, session, events, metrics) -> None:
        self._n += 1
        if self._n % max(self._obs.every, 1):
            return
        if not len(self.registry):
            return  # nothing published yet (e.g. an idle serve tick)
        from repro_torch.obs import counter_events, flatten_snapshot

        # flatten once; counter_events accepts the already-flat view
        flat = flatten_snapshot(self.registry.snapshot())
        ts = session.tracer.clock()
        if self._jsonl is not None:
            self._jsonl.write({"step": self._n, "ts": ts, **flat})
        if session.tracer.enabled:
            session.tracer.events.extend(counter_events(flat, ts=ts))

    def finalize(self, session) -> dict:
        from repro_torch.obs import flatten_snapshot, prometheus_text

        snap = self.registry.snapshot()
        out: dict = {
            "series": {
                k: round(v, 6) for k, v in flatten_snapshot(snap).items()
            },
        }
        if self._jsonl is not None:
            self._jsonl.close()
            out["metrics_out"] = str(self._jsonl.path)
            out["rows"] = self._jsonl.rows
        if self._obs.prom_out:
            p = Path(self._obs.prom_out)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(prometheus_text(self.registry))
            out["prom_out"] = str(p)
        flops_s = snap.get("train.model_flops_per_s")
        if self._obs.peak_tflops > 0 and isinstance(flops_s, dict):
            out["mfu_est"] = round(
                flops_s["p50"] / (self._obs.peak_tflops * 1e12), 6
            )
        return out


# ---------------------------------------------------------------------------
# MegaScope — probes + perturbations through the model hooks
# ---------------------------------------------------------------------------


def _parse_probe(spec: str):
    from repro_torch.core.scope import ProbeSpec

    pattern, _, compress = spec.partition(":")
    return ProbeSpec(pattern, compress or "stats")


def _parse_perturb(spec: str):
    from repro_torch.core.scope import PerturbSpec

    parts = spec.split(":")
    if len(parts) < 3:
        raise ValueError(
            f"perturb spec {spec!r}; want pattern:kind:amount[:layer]"
        )
    layer = int(parts[3]) if len(parts) > 3 else None
    return PerturbSpec(parts[0], parts[1], float(parts[2]), layer)


@register_plugin
class ScopePlugin(ModulePlugin):
    """Owns the session ScopeCollector, built from compact config strings.

    The train loop threads it through every step's loss; ``on_step``
    counts the captured leaves of each step's ``captures`` tree (still on
    the card: counting reads nothing back).
    """

    name = "scope"

    def setup(self, session) -> None:
        from repro_torch.core.scope import ScopeCollector

        sec = self.run_cfg.scope
        self._probes = [_parse_probe(s) for s in sec.probes]
        self._perturbs = [_parse_perturb(s) for s in sec.perturbs]
        session.collector = ScopeCollector(
            probes=self._probes, perturbs=self._perturbs
        )
        self._captured: dict[str, int] = {}

    def on_step(self, session, events, metrics) -> None:
        # captures ride the workload's metrics under a nested "captures"
        # tree ({segment: {"<tag>.<compressor>": leaf}}); count leaf hits
        def walk(prefix: str, node) -> None:
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(f"{prefix}{k}/" if isinstance(v, dict) else f"{prefix}{k}", v)
            else:
                self._captured[prefix] = self._captured.get(prefix, 0) + 1

        caps = (metrics or {}).get("captures") if isinstance(metrics, dict) else None
        if caps:
            walk("", caps)

    def finalize(self, session) -> dict:
        return {
            "probes": [f"{p.pattern}:{p.compress}" for p in self._probes],
            "perturbs": len(self._perturbs),
            "captured": dict(sorted(self._captured.items())),
        }


# ---------------------------------------------------------------------------
# MegaFBD — heterogeneous placement + coordination check
# ---------------------------------------------------------------------------


@register_plugin
class FbdPlugin(ModulePlugin):
    """Forward/backward-decoupling coordination for the configured cluster.

    ``setup`` plans virtual-rank placement over the section's heterogeneous
    speed model and verifies launch-order deadlock freedom with the
    bit-vector coordinator; ``finalize`` reports the decoupled-vs-colocated
    speedup.  Host-side planning only — step numerics are untouched, so the
    plugin composes with every workload.
    """

    name = "fbd"

    def setup(self, session) -> None:
        from repro_torch.core.fbd.coordinator import ThreadProgram, run_with_coordinator
        from repro_torch.core.fbd.ranks import (
            colocated_placement,
            evaluate_placement,
            plan_placement,
        )

        sec = self.run_cfg.fbd
        n_slow = int(sec.n_devices * sec.slow_frac)
        speed = {d: 1.0 for d in range(sec.n_devices - n_slow)}
        speed |= {d: sec.slow_speed for d in range(sec.n_devices - n_slow, sec.n_devices)}
        self.placement = plan_placement(sec.n_virtual, speed)
        self._t_decoupled = evaluate_placement(self.placement)
        self._t_colocated = evaluate_placement(
            colocated_placement(sec.n_virtual, speed)
        )
        # coordination check: each virtual rank posts one all-ranks group and
        # one pairwise group; the bit-vector protocol must order all of them
        # without deadlock on this placement's control threads
        vmap = self.placement.mapping
        n_v = sec.n_virtual
        groups = {0: tuple(range(n_v))}
        groups |= {1 + i: (i, i + 1) for i in range(n_v - 1)}
        programs = [
            ThreadProgram(
                vrank=v,
                control=vmap.control_thread(vmap.fwd_device[v]),
                group_ids=[0] + sorted(g for g, ms in groups.items() if g and v in ms),
            )
            for v in range(n_v)
        ]
        self._launch_order = run_with_coordinator(
            programs, groups, n_controls=sec.n_devices
        )

    def finalize(self, session) -> dict:
        return {
            "decoupled_ms": round(self._t_decoupled * 1e3, 3),
            "colocated_ms": round(self._t_colocated * 1e3, 3),
            "speedup": round(self._t_colocated / self._t_decoupled, 3),
            "coordinated_groups": len(self._launch_order),
        }


# ---------------------------------------------------------------------------
# MegaDPP — pipeline planning + step-time telemetry
# ---------------------------------------------------------------------------


@register_plugin
class DppPlugin(ModulePlugin):
    """Plans the pipeline schedule for the configured topology at ``setup``
    and folds observed step times in at ``finalize`` (the planner's
    telemetry-driven ``replan`` path takes the trace workload's
    ``Diagnosis``; here the live loop contributes measured step dispersion).
    """

    name = "dpp"

    def setup(self, session) -> None:
        from repro_torch.core.dpp.planner import Planner
        from repro_torch.core.simkit.workload import ModelProfile, Topology

        sec = self.run_cfg.dpp
        self.planner = Planner(
            Topology(dp=sec.dp, pp=sec.pp, tp=sec.tp),
            ModelProfile(n_chunks=sec.n_chunks),
            n_micro=sec.n_micro,
            memory_cap=int(sec.memory_cap_gib * (1 << 30)),
        )
        self.plan = self.planner.plan()
        self._step_durs: list[float] = []

    def on_step(self, session, events, metrics) -> None:
        for e in events:
            if e.name in ("train_step", "decode", "prefill", "verify"):
                self._step_durs.append(e.dur)

    def finalize(self, session) -> dict:
        import numpy as np

        durs = np.asarray(self._step_durs)
        out = {
            "schedule": self.plan.schedule_name,
            "wave": self.plan.wave,
            "makespan_ms": round(self.plan.makespan * 1e3, 3),
            "peak_memory_mib": self.plan.peak_memory >> 20,
        }
        if durs.size:
            out["step_ms_p50"] = round(float(np.median(durs)) * 1e3, 3)
            out["step_ms_max"] = round(float(durs.max()) * 1e3, 3)
        return out


# ---------------------------------------------------------------------------
# Fault tolerance — the detect -> decide -> mitigate -> recover controller
# ---------------------------------------------------------------------------


def chaos_spec(run_cfg):
    """The ``ft`` section's :class:`repro_torch.ft.ChaosSpec`, checked as
    the JAX plugin checks it: ``guard_action`` is rollback or skip, and a
    crash or a NaN rolled back needs ``train.ckpt_dir`` for a restore
    target.  ``Session`` also calls it before spawning a world's ranks."""
    from repro_torch.ft import ChaosSpec

    sec = run_cfg.ft
    c = sec.chaos
    spec = ChaosSpec(
        crash_at_step=c.crash_at_step, nan_at_step=c.nan_at_step,
        slow_rank_from=c.slow_rank_from, slow_rank=c.slow_rank,
        slow_factor=c.slow_factor, degrade_link=c.degrade_link,
        degrade_factor=c.degrade_factor,
    )
    if sec.guard_action not in ("rollback", "skip"):
        raise ValueError(
            f"ft.guard_action must be rollback|skip, got {sec.guard_action!r}")
    needs_ckpt = spec.crash_at_step >= 0 or (
        spec.nan_at_step >= 0 and sec.guard_action == "rollback")
    if needs_ckpt and not run_cfg.train.ckpt_dir:
        raise ValueError(
            "ft.chaos crash/NaN-rollback recovery needs train.ckpt_dir "
            "(--ckpt-dir) for a restore target")
    return spec


@register_plugin
class FtPlugin(ModulePlugin):
    """Owns the session :class:`repro_torch.ft.FtController`.

    Closes the loop the scan plugin's ``--detect-online`` opens: every
    online ``DetectionUpdate`` runs through ``MitigationPolicy.decide``, and
    the decisions execute in the train loop — gradient compression for a
    degraded DP link, a MegaDPP schedule replan around a slow stage, or a
    rank exclusion + checkpoint rollback.  The same controller supervises
    the loop (crash -> restore-latest -> resume, NaN/grad-spike guards) and
    drives the declarative chaos spec (``--set ft.chaos.*``) that proves the
    recovery end to end.  ``finalize`` reports the mitigation timeline,
    restart/rollback counters, and exclusions as ``results["ft"]``.
    """

    name = "ft"

    def setup(self, session) -> None:
        from repro_torch.ft import (
            ChaosInjector,
            FtController,
            FtOptions,
            MitigationPolicy,
        )

        sec = self.run_cfg.ft
        spec = chaos_spec(self.run_cfg)
        if ((spec.slow_rank_from >= 0 or spec.degrade_link)
                and not self.run_cfg.scan.detect_online):
            import logging

            logging.getLogger("repro_torch.ft").warning(
                "ft.chaos injects a straggler/degraded link but "
                "scan.detect_online is off — nothing will detect or "
                "mitigate it (add --detect-online)")
        self.controller = FtController(
            policy=MitigationPolicy(
                slow_frac_soft=sec.slow_frac_soft,
                slow_frac_hard=sec.slow_frac_hard,
                min_evidence=sec.min_evidence,
            ),
            chaos=ChaosInjector(spec) if spec.active else None,
            options=FtOptions(
                max_restarts=sec.max_restarts, backoff_s=sec.backoff_s,
                guard_nan=sec.guard_nan, guard_spike=sec.guard_spike,
                guard_action=sec.guard_action,
            ),
        )
        session.ft_controller = self.controller
        session.detection_listeners.append(self.controller.on_detection)

    def finalize(self, session) -> dict:
        return self.controller.report()
