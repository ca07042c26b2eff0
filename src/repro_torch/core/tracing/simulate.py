"""Distributed-trace simulator: simkit timeline -> per-rank local-clock traces.

Gives MegaScan a cluster-free test bed with controllable ground truth: inject
down-clocked ranks / degraded links / jitter (FaultModel) and per-rank clock
offset + drift + read noise (ClockModel); the analysis pipeline must recover
them.  (DESIGN.md §2: the CUDA-event signal is the only thing replaced; the
merge/align/detect pipeline is identical for simulated and real traces.)

A copy of ``repro.core.tracing.simulate``; the port keeps its own, as it
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.simkit.engine import Engine, FaultModel
from repro_torch.core.simkit.workload import ModelProfile, Topology, build_training_step
from repro_torch.core.tracing.events import TraceEvent


@dataclass
class ClockModel:
    offset_sigma: float = 5e-3     # initial offset spread across ranks (s)
    drift_sigma: float = 2e-5      # clock drift (s per s)
    read_noise: float = 2e-6       # per-timestamp measurement noise (s)
    seed: int = 0


def simulate_trace(
    topo: Topology,
    prof: ModelProfile,
    *,
    n_micro: int = 8,
    n_iters: int = 1,
    schedule: str = "1f1b",
    faults: FaultModel | None = None,
    clocks: ClockModel | None = None,
    async_p2p: bool = False,
) -> tuple[list[TraceEvent], dict]:
    """Returns (per-rank local-clock events, ground truth dict)."""
    clocks = clocks or ClockModel()
    faults = faults or FaultModel()
    rng = np.random.default_rng(clocks.seed)
    offsets = rng.normal(0.0, clocks.offset_sigma, topo.world)
    drifts = rng.normal(0.0, clocks.drift_sigma, topo.world)
    offsets[0] = 0.0
    drifts[0] = 0.0

    engine = Engine(faults=faults)
    events: list[TraceEvent] = []
    t_base = 0.0
    for it in range(n_iters):
        order = build_training_step(
            topo, prof, n_micro=n_micro, schedule=schedule, async_p2p=async_p2p
        )
        res = engine.run(order)
        for rec in res.records:
            r = rec.rank
            kind = {
                "compute": "compute",
                "allreduce": "coll", "allgather": "coll",
                "reducescatter": "coll", "alltoall": "coll",
                "send": "p2p", "recv": "p2p",
            }[rec.kind]
            args = dict(rec.meta)
            args["iter"] = it
            if kind == "coll":
                task = rec.tid
                args.setdefault("op", task.split("_")[0])
                # group recorded by the workload builder
            if kind == "p2p":
                args["dir"] = "send" if rec.kind == "send" else "recv"
            ts_true = t_base + rec.start
            te_true = t_base + rec.end
            ts_loc = (ts_true + offsets[r] + drifts[r] * ts_true
                      + rng.normal(0.0, clocks.read_noise))
            te_loc = (te_true + offsets[r] + drifts[r] * te_true
                      + rng.normal(0.0, clocks.read_noise))
            ev = TraceEvent(
                rec.tid, r, float(ts_loc), max(float(te_loc - ts_loc), 0.0),
                kind, args,
            )
            events.append(ev)
        t_base += res.makespan + 1e-3

    # attach group/bytes/peer args from the task definitions
    order_flat = {}
    for lst in order.values():
        for t in lst:
            order_flat[t.tid] = t
    for e in events:
        t = order_flat.get(e.name)
        if t is None:
            continue
        if t.group:
            e.args["group"] = t.group
        if t.bytes:
            e.args["bytes"] = t.bytes
        if t.peer is not None:
            e.args["peer"] = t.peer
        e.args.setdefault("op", t.tid.split("_")[0].rstrip("0123456789"))

    truth = {
        "offsets": offsets.tolist(),
        "drifts": drifts.tolist(),
        "slow_ranks": sorted(faults.compute_slowdown),
        "degraded_links": sorted(faults.link_slowdown),
        "makespan": res.makespan,
    }
    events.sort(key=lambda e: (e.ts, e.rank))
    return events, truth
