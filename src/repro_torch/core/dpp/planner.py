"""Resource-aware schedule planning (MegaDPP §5.1-5.2), copied from
``repro.core.dpp.planner``.

The planner evaluates candidate traversal orders on the simkit engine with the
*current* resource picture — compute/link health comes straight from MegaScan
telemetry (a ``Diagnosis``), memory budget from the device spec — and picks
the best-effort schedule: the largest BFC wave whose predicted activation
peak fits, preferring makespan, i.e. "adopt BFC as long as it does not OOM".

Between iterations ``replan`` folds fresh telemetry in (straggler mitigation:
a slow stage or degraded link shifts the optimum; the planner reacts without
restarting the job).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.dpp.schedule import sched_wave
from repro_torch.core.simkit.engine import DeadlockError, Engine, FaultModel
from repro_torch.core.simkit.workload import ModelProfile, Topology, build_training_step


@dataclass
class PlanResult:
    schedule_name: str
    wave: int
    makespan: float
    peak_memory: int
    grad_ready: float          # earliest time the first chunk's grads are done
    per_candidate: dict = field(default_factory=dict)

    def steps(self, n_micro: int, n_chunks: int):
        return sched_wave(n_micro, n_chunks, self.wave)


@dataclass
class Planner:
    topo: Topology
    prof: ModelProfile
    n_micro: int
    memory_cap: int = 16 << 30
    async_p2p: bool = True
    link_bandwidth: float = 50e9
    faults: FaultModel = field(default_factory=FaultModel)

    def _evaluate(self, wave: int) -> tuple[float, int, float] | None:
        steps = sched_wave(self.n_micro, self.prof.n_chunks, wave)
        order = build_training_step(
            self.topo, self.prof, n_micro=self.n_micro,
            schedule={p: list(steps) for p in range(self.topo.pp)},
            async_p2p=self.async_p2p,
        )
        engine = Engine(
            faults=self.faults,
            link_bandwidth=self.link_bandwidth,
            link_concurrency=4 if self.async_p2p else 1,
        )
        try:
            res = engine.run(order)
        except DeadlockError:
            return None
        peak = max(res.peak_memory.values())
        # gradient-sync readiness: the earliest chunk to finish *all* its
        # backward work could start its gradient all-reduce then (BFC's
        # claimed benefit: per-chunk sync starts before the iteration ends)
        per_chunk: dict[int, float] = {}
        for r in res.records:
            if r.kind == "compute" and r.meta.get("phase") == "B":
                c = r.meta.get("chunk", 0)
                per_chunk[c] = max(per_chunk.get(c, 0.0), r.end)
        grad_ready = min(per_chunk.values()) if per_chunk else res.makespan
        return res.makespan, peak, grad_ready

    def plan(self) -> PlanResult:
        candidates: dict[int, tuple[float, int, float]] = {}
        waves = sorted({1, 2, self.n_micro // 2, self.n_micro} - {0})
        for w in waves:
            r = self._evaluate(w)
            if r is not None:
                candidates[w] = r
        # best-effort BFC: among schedules that fit the memory cap, take the
        # fastest; tie-break toward larger wave (earlier grad readiness)
        fitting = {w: v for w, v in candidates.items() if v[1] <= self.memory_cap}
        pool = fitting or candidates
        best_w = min(pool, key=lambda w: (pool[w][0], -w))
        mk, peak, gr = pool[best_w]
        name = {1: "dfc"}.get(best_w, "bfc" if best_w == self.n_micro else f"wave{best_w}")
        return PlanResult(
            schedule_name=name, wave=best_w, makespan=mk, peak_memory=peak,
            grad_ready=gr,
            per_candidate={
                w: {"makespan": v[0], "peak_mem": v[1], "grad_ready": v[2],
                    "fits": v[1] <= self.memory_cap}
                for w, v in candidates.items()
            },
        )

    def replan(self, diagnosis) -> PlanResult:
        """Fold MegaScan telemetry into the resource picture and re-plan."""
        self.faults = self.faults.merged(
            compute_slowdown={
                r: 0.5 for r in getattr(diagnosis, "slow_ranks", [])
            },
            link_slowdown={
                tuple(l): 0.5 for l in getattr(diagnosis, "degraded_links", [])
            },
        )
        return self.plan()
