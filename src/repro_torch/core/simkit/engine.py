"""Discrete-event engine for 3-D-parallel training timelines.

One engine serves three MegatronApp modules:

* **MegaScan** — generates realistic per-rank traces (with injectable
  down-clocked ranks, degraded links, clock offset/drift/jitter) that feed the
  alignment + straggler-detection pipeline;
* **MegaDPP** — evaluates traversal orders (DFC / BFC / 1F1B / best-effort)
  for makespan, communication overlap, and peak activation memory;
* **MegaFBD** — evaluates forward/backward placements on heterogeneous
  devices and demonstrates the deadlock the communication coordinator
  prevents (mismatched collective issue orders block forever — the engine
  detects this).

Execution semantics mirror a blocking runtime (NCCL-style):

* each rank executes its task list **in order**; a task starts when the rank
  is free and all its dependencies have finished;
* a collective starts only when *all* participating ranks have reached it
  (their cursors point at the collective and its deps are met); all members
  finish together;
* point-to-point transfers occupy a (src, dst) link; a link admits at most
  ``link_concurrency`` simultaneous transfers (1 = serialized NCCL-ish,
  >1 = MegaDPP's async P2P library).

A copy of ``repro.core.simkit.engine``; the port keeps its own, as it
imports nothing of the JAX package.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Any, Iterable

import numpy as np


@dataclass
class Task:
    tid: str
    rank: int
    duration: float = 0.0          # seconds of pure compute (scaled by speed)
    bytes: int = 0                 # payload for comm tasks
    kind: str = "compute"          # compute|allreduce|allgather|reducescatter|send|recv|alltoall
    deps: tuple[str, ...] = ()
    coll_id: str | None = None     # shared by all members of one collective
    group: tuple[int, ...] = ()    # participating ranks for collectives
    peer: int | None = None        # for send/recv
    meta: dict = field(default_factory=dict)
    alloc: int = 0                 # activation bytes allocated on completion
    free: int = 0                  # activation bytes freed on completion
    blocking: bool = True          # False = async issue (MegaDPP P2P library):
                                   # the rank pays only launch latency; the
                                   # transfer itself occupies the link


@dataclass
class TaskRecord:
    tid: str
    rank: int
    start: float
    end: float
    kind: str
    bytes: int = 0
    meta: dict = field(default_factory=dict)


class DeadlockError(RuntimeError):
    def __init__(self, msg: str, blocked: dict[int, str]):
        super().__init__(msg)
        self.blocked = blocked


@dataclass
class FaultModel:
    """Injectable anomalies (MegaScan ground truth)."""

    compute_slowdown: dict[int, float] = field(default_factory=dict)  # rank -> x
    link_slowdown: dict[tuple[int, int], float] = field(default_factory=dict)
    jitter: float = 0.0            # multiplicative task-duration noise (sigma)
    seed: int = 0

    def speed(self, rank: int) -> float:
        return self.compute_slowdown.get(rank, 1.0)

    def link(self, src: int, dst: int) -> float:
        return self.link_slowdown.get((src, dst), 1.0)

    def merged(
        self,
        *,
        compute_slowdown: dict[int, float] | None = None,
        link_slowdown: dict[tuple[int, int], float] | None = None,
    ) -> "FaultModel":
        """A new model with fresh telemetry folded over this one (newer
        observations win) — how ``Planner.replan`` and the live ft
        controller update the resource picture between iterations."""
        return FaultModel(
            compute_slowdown={**self.compute_slowdown, **(compute_slowdown or {})},
            link_slowdown={**self.link_slowdown, **(link_slowdown or {})},
            jitter=self.jitter,
            seed=self.seed,
        )


@dataclass
class EngineResult:
    records: list[TaskRecord]
    makespan: float
    peak_memory: dict[int, int]          # rank -> peak activation bytes
    per_rank_busy: dict[int, float]

    def by_rank(self) -> dict[int, list[TaskRecord]]:
        out: dict[int, list[TaskRecord]] = {}
        for r in self.records:
            out.setdefault(r.rank, []).append(r)
        for lst in out.values():
            lst.sort(key=lambda t: t.start)
        return out


class Engine:
    def __init__(
        self,
        *,
        link_bandwidth: float = 50e9,      # bytes/s per ICI link
        collective_bandwidth: float = 50e9,
        base_latency: float = 5e-6,        # per-op launch latency
        link_concurrency: int = 1,
        faults: FaultModel | None = None,
    ):
        self.link_bandwidth = link_bandwidth
        self.collective_bandwidth = collective_bandwidth
        self.base_latency = base_latency
        self.link_concurrency = link_concurrency
        self.faults = faults or FaultModel()
        self._rng = np.random.default_rng(self.faults.seed)

    # ------------------------------------------------------------------
    def _task_time(self, t: Task) -> float:
        f = self.faults
        if t.kind == "compute":
            dur = t.duration / f.speed(t.rank)
        elif t.kind in ("send", "recv"):
            bw = self.link_bandwidth * f.link(t.rank, t.peer if t.peer is not None else t.rank)
            dur = t.bytes / bw
        else:  # collectives: slowest member's effective bandwidth bounds it
            slow = min(
                (f.link(r, r2) for r in t.group for r2 in t.group if r != r2),
                default=1.0,
            )
            dur = t.bytes / (self.collective_bandwidth * slow)
        if f.jitter > 0:
            dur *= float(
                np.exp(self._rng.normal(0.0, f.jitter))
            )
        return dur + self.base_latency

    # ------------------------------------------------------------------
    def run(self, order: dict[int, list[Task]]) -> EngineResult:
        """Execute per-rank ordered task lists; returns the timeline."""
        tasks: dict[str, Task] = {}
        for lst in order.values():
            for t in lst:
                if t.tid in tasks:
                    raise ValueError(f"duplicate task id {t.tid}")
                tasks[t.tid] = t

        finish: dict[str, float] = {}
        cursor = {r: 0 for r in order}
        rank_free = {r: 0.0 for r in order}
        records: list[TaskRecord] = []
        mem = {r: 0 for r in order}
        peak = {r: 0 for r in order}
        busy = {r: 0.0 for r in order}
        # collective rendezvous: coll_id -> {rank: ready_time}
        arrivals: dict[str, dict[int, float]] = {}
        # link occupancy for P2P concurrency limits: (src,dst) -> end times
        links: dict[tuple[int, int], list[float]] = {}

        n_total = sum(len(v) for v in order.values())
        n_done = 0
        progressed = True
        while n_done < n_total:
            if not progressed:
                blocked = {
                    r: order[r][c].tid for r, c in cursor.items() if c < len(order[r])
                }
                raise DeadlockError(
                    f"no runnable task ({n_done}/{n_total} done); "
                    f"blocked={blocked}", blocked,
                )
            progressed = False

            for r in order:
                c = cursor[r]
                if c >= len(order[r]):
                    continue
                t = order[r][c]
                if any(d not in finish for d in t.deps):
                    continue
                dep_ready = max((finish[d] for d in t.deps), default=0.0)
                ready = max(dep_ready, rank_free[r])

                if t.coll_id is not None:
                    arr = arrivals.setdefault(t.coll_id, {})
                    arr[r] = ready
                    if set(arr) != set(t.group):
                        # mark arrival but cannot start yet; rank blocks here
                        continue
                    start = max(arr.values())
                    dur = self._task_time(t)
                    end = start + dur
                    for rr in t.group:
                        member = order[rr][cursor[rr]]
                        finish[member.tid] = end
                        records.append(TaskRecord(
                            member.tid, rr, arr[rr], end, member.kind,
                            member.bytes, member.meta,
                        ))
                        rank_free[rr] = end
                        busy[rr] += end - arr[rr]
                        mem[rr] += member.alloc - member.free
                        peak[rr] = max(peak[rr], mem[rr])
                        cursor[rr] += 1
                        n_done += 1
                    del arrivals[t.coll_id]
                    progressed = True
                    continue

                if t.kind in ("send", "recv") and t.peer is not None:
                    edge = (min(t.rank, t.peer), max(t.rank, t.peer))
                    q = links.setdefault(edge, [])
                    # admit when a slot frees up
                    active = [e for e in q if e > ready]
                    if len(active) >= self.link_concurrency:
                        start = sorted(active)[-self.link_concurrency]
                    else:
                        start = ready
                else:
                    start = ready

                dur = self._task_time(t)
                end = start + dur
                if t.kind in ("send", "recv") and t.peer is not None:
                    links.setdefault(edge, []).append(end)
                finish[t.tid] = end
                records.append(TaskRecord(t.tid, r, start, end, t.kind, t.bytes, t.meta))
                if t.blocking:
                    rank_free[r] = end
                    busy[r] += dur
                else:
                    # async issue: the rank only pays the launch latency; the
                    # dependent consumer still waits for the transfer finish
                    rank_free[r] = max(rank_free[r], ready + self.base_latency)
                    busy[r] += self.base_latency
                mem[r] += t.alloc - t.free
                peak[r] = max(peak[r], mem[r])
                cursor[r] += 1
                n_done += 1
                progressed = True

        makespan = max(finish.values(), default=0.0)
        return EngineResult(records, makespan, peak, busy)
