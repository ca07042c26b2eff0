"""MegaRoute: router-fronted multi-replica serving.

Counterpart of ``repro.serve.router.router``.  A ``Router`` fronts N
``MegaServe`` replicas — each with its own KV pool and scheduler over one
shared set of compute-dtype weights — stepped round-robin inside one
process, on one device.
Per tick it:

* **places** arrived requests onto a replica via a pluggable policy
  (``round_robin`` / ``least_kv`` / ``jsq``) with SLO-aware admission:
  a TTFT estimate from the replica's live queue/occupancy snapshot
  (``estimate_ttft`` over a ``PlacementView``) decides admit vs redirect
  vs shed — the *same* functions ``router_workload`` evaluates offline,
  so an offline policy ranking transfers to the live engines;
* **migrates** prefilled KV between replicas when prefill/decode
  disaggregation is on (``prefill_replicas > 0``): prefill-only replicas
  emit each request's first token, then the router exports the slot's KV
  blocks (``PagedKVCache.export_slot``) and adopts them into a decode
  replica (``import_slot``) — bit-identical blocks, so the greedy
  continuation is token-identical to a colocated run;
* **steps** every replica once, merging their streams/metrics/traces.

The replicas are real engines, not simulations: policies are compared on
actual prefill/decode wall time, and the chunked-prefill and speculative
paths run unchanged underneath the router.  On the card every replica
launches the same kernels a single engine does (K4 for its prompts, K3 for
its decode ticks, K1 for every norm).  ``precompile()`` warms every
replica's bucket ladders, through the compile cache when one is attached
(``compile_cache=`` reaches every replica).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.simkit.workload import (
    POLICIES,
    PlacementView,
    ServeProfile,
    admission_decision,
    place,
)
from repro_torch.core.tracing.tracer import Tracer
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.hooks import NULL_COLLECTOR, Collector
from repro_torch.serve.request import aggregate_metrics
from repro_torch.serve.scheduler import ServeConfig
from repro_torch.serve.server import MegaServe
from repro_torch.serve.spec import Drafter


@dataclass(frozen=True)
class RouterConfig:
    """Router-level knobs (replica topology + placement/admission policy).

    ``replicas`` engine replicas serve behind one router.  ``policy`` picks
    the placement rule (a key of ``simkit.workload.POLICIES``).  With
    ``prefill_replicas = k > 0`` the first ``k`` replicas are prefill-only
    and the rest decode-only: new requests are placed on prefill replicas,
    and their KV migrates to a decode replica after the first token
    (disaggregation); ``0`` keeps every replica colocated.  ``slo_ttft_s``
    enables SLO-aware admission (``0`` disables it): a request whose
    estimated TTFT busts the SLO on the policy's pick is redirected to a
    replica that meets it, or shed entirely when none does (``shed=False``
    admits on the least-bad replica instead of shedding).
    """

    replicas: int = 2
    policy: str = "round_robin"
    prefill_replicas: int = 0
    slo_ttft_s: float = 0.0
    shed: bool = True

    def __post_init__(self) -> None:
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown router policy {self.policy!r}; "
                f"one of {sorted(POLICIES)}"
            )
        if self.prefill_replicas < 0:
            raise ValueError(
                f"prefill_replicas must be >= 0, got {self.prefill_replicas}"
            )
        if self.prefill_replicas >= self.replicas and self.prefill_replicas:
            raise ValueError(
                f"prefill_replicas={self.prefill_replicas} needs at least "
                f"one decode replica (replicas={self.replicas}); "
                "disaggregation splits the fleet, it cannot consume all of it"
            )
        if self.slo_ttft_s < 0:
            raise ValueError(
                f"slo_ttft_s must be >= 0, got {self.slo_ttft_s}"
            )

    @property
    def disaggregated(self) -> bool:
        return self.prefill_replicas > 0


class Router:
    """Front ``cfg.replicas`` MegaServe engines with placement, SLO-aware
    admission, and (optionally) disaggregated prefill→decode KV migration.

    Mirrors the single-engine surface — ``submit() / step() / drain() /
    metrics() / streams()`` — so launchers and benchmarks swap it in
    wherever a ``MegaServe`` went.  All replicas share one clock (t=0 at
    router construction), so arrival stamps and TTFTs are comparable
    across the fleet.

    ``params`` are cast to the compute dtype on ``device`` once, here, and
    every replica serves that one tree (JAX's replicas share one
    ``params``): two replicas hold one copy of the weights and two pools.
    ``device`` defaults to the card, as ``MegaServe``'s does.  The
    ``ServeProfile`` constants are the TTFT estimator's inputs, copied from
    the JAX package as they are; they are not measurements of any device.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        serve_cfg: ServeConfig = ServeConfig(),
        router_cfg: RouterConfig = RouterConfig(),
        *,
        collector: Collector = NULL_COLLECTOR,
        tracer: Tracer | None = None,
        clock: Callable[[], float] | None = None,
        drafter: Drafter | None = None,
        device: str = "cuda",
        wrap_step: Callable[[Callable], Callable] | None = None,
        replica_wrap_steps: Sequence[Callable | None] | None = None,
        replica_step_every: Sequence[int] | None = None,
        registry=None,
        profile: ServeProfile = ServeProfile(),
        compile_cache=None,
    ):
        self.router_cfg = router_cfg
        self.registry = registry
        self.profile = profile
        # router-level trace lane: placement / shed / migration hand-off
        # events; each replica traces its own compute on rank=i
        self.tracer = tracer or Tracer(rank=router_cfg.replicas, enabled=True)
        self._raw_clock = clock or time.perf_counter
        self._base = self._raw_clock()
        self._clock = lambda: self._raw_clock() - self._base

        if replica_wrap_steps is not None and (
            len(replica_wrap_steps) != router_cfg.replicas
        ):
            raise ValueError(
                f"replica_wrap_steps has {len(replica_wrap_steps)} entries "
                f"for {router_cfg.replicas} replicas"
            )
        # heterogeneous-speed emulation: replica i is stepped only every
        # ``replica_step_every[i]``-th router tick.  Inside one process the
        # replicas step in lockstep, so wall-clock tricks (sleeping inside a
        # replica's engine step) slow every replica's tick equally and leave
        # per-tick throughput symmetric; thinning a replica's steps is the
        # honest single-process analogue of a 1/k-speed straggler, matching
        # the offline model's ``replica_speeds`` semantics.  Greedy streams
        # are unaffected — only when steps happen, never what they compute.
        if replica_step_every is None:
            replica_step_every = [1] * router_cfg.replicas
        if len(replica_step_every) != router_cfg.replicas:
            raise ValueError(
                f"replica_step_every has {len(replica_step_every)} entries "
                f"for {router_cfg.replicas} replicas"
            )
        if any(int(e) < 1 for e in replica_step_every):
            raise ValueError(
                f"replica_step_every entries must be >= 1, "
                f"got {list(replica_step_every)}"
            )
        self._step_every = [int(e) for e in replica_step_every]
        self.tick = 0
        dev = resolve_device(device)
        params = lm.cast_params(params, getattr(torch, cfg.compute_dtype), dev)
        self.replicas: list[MegaServe] = []
        for i in range(router_cfg.replicas):
            wrap = wrap_step
            if replica_wrap_steps is not None and replica_wrap_steps[i]:
                wrap = replica_wrap_steps[i]
            srv = MegaServe(
                cfg, params, serve_cfg,
                collector=collector,
                tracer=Tracer(rank=i, enabled=True),
                clock=self._raw_clock,
                drafter=drafter,
                device=dev,
                wrap_step=wrap,
                registry=registry,
                metrics_prefix=f"serve.r{i}.",
                prefill_only=(
                    router_cfg.disaggregated and i < router_cfg.prefill_replicas
                ),
                compile_cache=compile_cache,
            )
            # share the router's epoch: every replica clock reads t=0 at
            # router construction (the _clock lambda reads _base at call
            # time, so overwriting it after construction is sufficient)
            srv._base = self._base
            self.replicas.append(srv)

        # pending: submitted but not yet placed (arrival in the future)
        self._pending: list[dict] = []
        # exported KV packages waiting for a decode replica with capacity
        self.migrations: list[dict] = []
        self._next_rid = 0
        self._rr = 0          # placement cursor (round_robin)
        self._rr_mig = 0      # migration-target cursor
        self.shed_rids: dict[int, float] = {}   # rid -> estimated ttft
        self.n_redirects = 0
        self.n_migrations = 0
        self.placed: dict[int, int] = {}        # rid -> replica index

    @classmethod
    def from_session(
        cls, session, params: Any, serve_cfg: ServeConfig,
        router_cfg: RouterConfig, **kw,
    ):
        """Router wired to a ``repro_torch.app.Session``: replicas share the
        session's MegaScope collector, metrics registry, device and compile
        cache, and every replica's engine steps run through the plugins'
        ``wrap_step``."""
        kw.setdefault("registry", getattr(session, "metrics_registry", None))
        kw.setdefault("device", session.device)
        kw.setdefault("compile_cache", getattr(session, "compile_cache", None))
        return cls(
            session.model_cfg, params, serve_cfg, router_cfg,
            collector=session.collector, wrap_step=session.wrap_step, **kw,
        )

    # -------------------------------------------------------------- intake
    @property
    def _intake(self) -> list[int]:
        """Replica indices new requests may be placed on: the prefill tier
        when disaggregated, the whole fleet when colocated."""
        rc = self.router_cfg
        if rc.disaggregated:
            return list(range(rc.prefill_replicas))
        return list(range(rc.replicas))

    @property
    def _decoders(self) -> list[int]:
        rc = self.router_cfg
        return list(range(rc.prefill_replicas, rc.replicas))

    def submit(
        self,
        prompt: list[int],
        max_new: int,
        *,
        arrival: float | None = None,
        eos_id: int | None = None,
    ) -> int:
        """Queue a prompt with a globally-unique rid; placement happens at
        arrival time (inside ``step``), when replica load is observable."""
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append({
            "rid": rid, "prompt": list(prompt), "max_new": max_new,
            "arrival": self._clock() if arrival is None else arrival,
            "eos_id": eos_id,
        })
        self._pending.sort(key=lambda p: (p["arrival"], p["rid"]))
        return rid

    def _view(self, idx: int) -> PlacementView:
        """Live load snapshot of replica ``idx`` in the exact shape the
        offline evaluator uses, so policy decisions match bit-for-bit."""
        srv = self.replicas[idx]
        sched = srv.sched
        alloc = sched.allocator
        used = alloc.num_blocks - alloc.reserved - alloc.num_free
        return PlacementView(
            queued=len(sched.waiting),
            queued_prefill_tokens=sum(
                len(sched.requests[r].recompute_prompt) for r in sched.waiting
            ),
            active=len(sched.active_slots()),
            kv_used_frac=used / max(srv.serve_cfg.usable_blocks, 1),
        )

    def _place_arrivals(self, now: float) -> tuple[list[int], list[int]]:
        """Route every pending request whose arrival has passed; returns
        (placed rids, shed rids)."""
        rc = self.router_cfg
        placed, shed = [], []
        while self._pending and self._pending[0]["arrival"] <= now:
            p = self._pending.pop(0)
            intake = self._intake
            views = [self._view(i) for i in intake]
            action, pick, est = admission_decision(
                rc.policy, views, len(p["prompt"]),
                prof=self.profile, rr=self._rr,
                slo_ttft_s=rc.slo_ttft_s, shed=rc.shed,
            )
            self._rr += 1
            t0 = self._clock()
            if action == "shed":
                self.shed_rids[p["rid"]] = est
                shed.append(p["rid"])
                self.tracer.record(
                    "shed", t0, 0.0, kind="host", rid=p["rid"],
                    est_ttft=est, slo=rc.slo_ttft_s,
                )
                if self.registry is not None:
                    self.registry.counter("router.shed").inc()
                continue
            if action == "redirect":
                self.n_redirects += 1
                if self.registry is not None:
                    self.registry.counter("router.redirects").inc()
            replica = intake[pick]
            srv = self.replicas[replica]
            srv.submit(
                p["prompt"], p["max_new"],
                arrival=p["arrival"], eos_id=p["eos_id"], rid=p["rid"],
            )
            self.placed[p["rid"]] = replica
            placed.append(p["rid"])
            self.tracer.record(
                "route", t0, 0.0, kind="host", rid=p["rid"],
                replica=replica, action=action, est_ttft=est,
            )
            if self.registry is not None:
                self.registry.counter("router.placed").inc()
                self.registry.counter(f"router.placed_r{replica}").inc()
        return placed, shed

    # ---------------------------------------------------------- migration
    def _try_adopt(self, package: dict) -> bool:
        """Hand an exported KV package to a decode replica: the placement
        policy picks the preferred target, the rest are fallbacks in order
        (a full replica returns the package untouched)."""
        decoders = self._decoders
        views = [self._view(i) for i in decoders]
        first = place(self.router_cfg.policy, views, self._rr_mig)
        self._rr_mig += 1
        order = [decoders[first]] + [
            d for j, d in enumerate(decoders) if j != first
        ]
        for idx in order:
            if self.replicas[idx].adopt_request(package):
                rid = package["req"].rid
                self.placed[rid] = idx
                self.n_migrations += 1
                self.tracer.record(
                    "migrate", self._clock(), 0.0, kind="host",
                    rid=rid, replica=idx, blocks=package["n_blocks"],
                )
                if self.registry is not None:
                    self.registry.counter("router.migrations").inc()
                return True
        return False

    def _migrate(self) -> int:
        """Drain prefill-tier completions into the decode tier: export every
        ready slot (freeing prefill capacity immediately), then adopt as
        many packages as the decode tier has room for; the rest retry next
        tick.  Oldest packages first — migration is FIFO so a burst cannot
        starve an early request."""
        if not self.router_cfg.disaggregated:
            return 0
        for i in self._intake:
            srv = self.replicas[i]
            for rid in srv.exportable():
                self.migrations.append(srv.export_request(rid))
        moved = 0
        remaining = []
        for package in self.migrations:
            if self._try_adopt(package):
                moved += 1
            else:
                remaining.append(package)
        self.migrations = remaining
        return moved

    # --------------------------------------------------------------- step
    def step(self) -> dict:
        """One router tick: place arrivals, retry queued migrations, step
        every replica once, then harvest fresh prefill completions."""
        now = self._clock()
        placed, shed = self._place_arrivals(now)
        moved = self._migrate()   # queued packages first: frees decode work
        admitted, finished, preempted = [], [], 0
        active = tokens = 0
        for i, srv in enumerate(self.replicas):
            if self.tick % self._step_every[i]:
                # thinned-out replica: skipped this tick, but its live slots
                # still count as work so drain doesn't idle past them
                active += len(srv.sched.active_slots())
                continue
            rep = srv.step()
            admitted += rep["admitted"]
            finished += rep["finished"]
            preempted += len(rep["preempted"])
            active += rep["active"]
            tokens += rep["tokens"]
        self.tick += 1
        moved += self._migrate()  # fresh exports from this tick's prefills
        if self.registry is not None and (placed or active or moved):
            self.registry.gauge("router.pending").set(len(self._pending))
            self.registry.gauge("router.migrations_queued").set(
                len(self.migrations)
            )
        return {
            "placed": placed, "shed": shed, "migrated": moved,
            "admitted": admitted, "finished": finished,
            "preempted": preempted, "active": active, "tokens": tokens,
        }

    # -------------------------------------------------------------- drain
    @property
    def all_done(self) -> bool:
        return (
            not self._pending
            and not self.migrations
            and all(srv.sched.all_done for srv in self.replicas)
        )

    def next_arrival(self) -> float | None:
        if not self._pending:
            return None
        return self._pending[0]["arrival"]

    def drain(
        self,
        max_steps: int = 100_000,
        *,
        on_step: Callable[[list, dict], None] | None = None,
    ) -> dict[int, list[int]]:
        """Run until every placed request finishes; returns merged streams
        (shed rids are absent — check ``shed_rids``).  ``on_step(events,
        report)`` observes each tick with the TraceEvents all lanes (router
        + replicas) emitted, mirroring ``MegaServe.drain``."""
        tracers = [self.tracer] + [srv.tracer for srv in self.replicas]
        marks = [len(t.events) for t in tracers]
        work = idle = 0
        while not self.all_done:
            out = self.step()
            if on_step is not None:
                events = []
                for k, t in enumerate(tracers):
                    events += t.events[marks[k]:]
                    marks[k] = len(t.events)
                events.sort(key=lambda e: e.ts)
                on_step(events, out)
            busy = (
                out["placed"] or out["migrated"] or out["admitted"]
                or out["active"] or self.migrations
            )
            if busy:
                work += 1
                idle = 0
                if work > max_steps:
                    raise RuntimeError(f"drain: not done after {work} steps")
                continue
            idle += 1
            if idle > max_steps:
                raise RuntimeError(
                    f"drain: stalled waiting for arrival at "
                    f"t={self.next_arrival()} (now={self._clock():.3f})"
                )
            nxt = self.next_arrival()
            if nxt is not None:
                time.sleep(max(0.0, min(nxt - self._clock(), 1e-3)))
        return self.streams()

    def precompile(self) -> dict:
        """Warm every replica's bucketed step variants (see
        ``MegaServe.precompile``), so no replica pays a kernel build or a
        first launch inside the serving loop.  Returns the per-path counts
        and milliseconds summed over the fleet (prefill / chunk / verify /
        decode, plus ``total``)."""
        agg: dict[str, Any] = {}
        for srv in self.replicas:
            rep = srv.precompile()
            for k, v in rep.items():
                if not isinstance(v, dict) or k == "cache":
                    continue
                a = agg.setdefault(k, {"count": 0, "ms": 0.0})
                a["count"] += v["count"]
                a["ms"] += v["ms"]
        agg["total"] = sum(v["count"] for v in agg.values())
        return agg

    # ------------------------------------------------------------- output
    def streams(self) -> dict[int, list[int]]:
        """rid -> generated tokens, merged across replicas.  After drain a
        rid's stream lives on exactly one replica (migration moves it)."""
        out: dict[int, list[int]] = {}
        for srv in self.replicas:
            for rid, items in srv.streams.items():
                out[rid] = [it.token for it in items]
        return out

    def metrics(self) -> dict:
        """Fleet metrics over every replica's requests, plus router-level
        accounting: placement spread, redirects, shed rate, migrations."""
        reqs = []
        for srv in self.replicas:
            reqs += list(srv.sched.requests.values())
        out = aggregate_metrics(reqs, wall=self._clock())
        submitted = self._next_rid
        replica_tokens = [
            sum(len(r.generated) for r in srv.sched.requests.values())
            for srv in self.replicas
        ]
        placed_per = [0] * self.router_cfg.replicas
        for rep in self.placed.values():
            placed_per[rep] += 1
        out.update({
            "steps": sum(srv.step_idx for srv in self.replicas),
            "submitted": submitted,
            "shed": len(self.shed_rids),
            "shed_rate": len(self.shed_rids) / submitted if submitted else 0.0,
            "redirects": self.n_redirects,
            "migrations": self.n_migrations,
            "placed_per_replica": placed_per,
            "replica_tokens": replica_tokens,
            "load_skew": (
                max(replica_tokens) / max(min(replica_tokens), 1)
                if replica_tokens else 0.0
            ),
        })
        return out

    def trace_events(self):
        """All lanes merged (router rank=N, replicas rank=0..N-1), by ts."""
        events = list(self.tracer.events)
        for srv in self.replicas:
            events += srv.tracer.events
        return sorted(events, key=lambda e: e.ts)

    def reset(self) -> None:
        """Drop all finished state and restart the shared clock (replicas
        keep their engine steps and pools, so a warmed-up fleet re-times
        cleanly)."""
        if not self.all_done:
            raise RuntimeError("reset() with requests still in flight")
        self._base = self._raw_clock()
        for srv in self.replicas:
            srv.reset()
            srv._base = self._base
        self.tracer.clear()
        self._pending.clear()
        self.migrations.clear()
        self.shed_rids.clear()
        self.placed.clear()
        self._next_rid = 0
        self._rr = self._rr_mig = 0
        self.n_redirects = self.n_migrations = 0
        self.tick = 0
