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

The port runs MegaScan (``scan``) and the metrics registry (``metrics``).
``ft``, ``scope``, ``fbd`` and ``dpp`` are registered, so ``--modules``
validates as in the JAX package, and their ``setup`` raises
``NotImplementedError`` naming the ROADMAP item that ports each.
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
    chrome export).  ``--detect-online`` (the online straggler detector) is
    ported with MegaFT (ROADMAP queue 1, item 9).
    """

    name = "scan"

    def setup(self, session) -> None:
        from repro_torch.core.tracing.tracer import AsyncTraceWriter, Tracer

        sc = self._scan_cfg = self.run_cfg.scan
        if sc.detect_online:
            raise NotImplementedError(
                "--detect-online (the online straggler detector) is ported "
                "with MegaFT (ROADMAP queue 1, item 9)")
        session.tracer = Tracer(rank=sc.rank, enabled=True)
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
# Modules of later slices: registered so --modules validates, refused at setup
# ---------------------------------------------------------------------------


class _LaterPlugin(ModulePlugin):
    module = ""
    item = ""

    def setup(self, session) -> None:
        raise NotImplementedError(
            f"the {self.name!r} module ({self.module}) is ported in a later "
            f"slice (ROADMAP queue 1, {self.item})")


@register_plugin
class FtPlugin(_LaterPlugin):
    name, module, item = "ft", "MegaFT", "item 9"


@register_plugin
class ScopePlugin(_LaterPlugin):
    name, module, item = "scope", "MegaScope", "item 6"


@register_plugin
class FbdPlugin(_LaterPlugin):
    name, module, item = "fbd", "MegaFBD", "item 7"


@register_plugin
class DppPlugin(_LaterPlugin):
    name, module, item = "dpp", "MegaDPP", "item 8"
