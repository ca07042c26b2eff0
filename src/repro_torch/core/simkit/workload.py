"""Task-graph builders for the discrete-event engine: the training half of
``repro.core.simkit.workload``, copied.

Training: one 3-D-parallel (DP x PP x TP) iteration.  The pipeline traversal
order is pluggable — MegaDPP's scheduler emits the (model_chunk, microbatch)
visit order per rank (DFC / BFC / 1F1B / custom) and this module lowers it
into engine tasks: stage compute (with per-layer TP collectives folded in),
inter-stage P2P sends/recvs, and the DP gradient all-reduce after the last
backward.  Rank layout follows Megatron order:
rank = dp * (PP*TP) + pp * TP + tp.

The serving and router half (``serving_workload`` and the MegaRoute
policies) is ported with MegaRoute (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.simkit.engine import Task


@dataclass(frozen=True)
class Topology:
    dp: int = 1
    pp: int = 1
    tp: int = 1

    @property
    def world(self) -> int:
        return self.dp * self.pp * self.tp

    def rank(self, d: int, p: int, t: int) -> int:
        return d * self.pp * self.tp + p * self.tp + t

    def coords(self, rank: int) -> tuple[int, int, int]:
        d, rem = divmod(rank, self.pp * self.tp)
        p, t = divmod(rem, self.tp)
        return d, p, t


@dataclass(frozen=True)
class ModelProfile:
    """Per-(stage, microbatch) cost profile in seconds/bytes."""

    fwd_time: float = 1e-3
    bwd_time: float = 2e-3
    tp_bytes: int = 32 << 20         # TP collective payload per stage pass
    p2p_bytes: int = 16 << 20        # boundary activation tensor
    grad_bytes: int = 256 << 20      # DP gradient sync per rank
    act_bytes: int = 64 << 20        # activation stash per in-flight microbatch
    n_chunks: int = 1                # virtual model chunks per stage (interleaving)


# One pipeline step per rank: (kind, microbatch, chunk) with kind F or B
Step = tuple[str, int, int]


def sched_1f1b(n_micro: int, n_chunks: int, pp: int, stage: int) -> list[Step]:
    """Classic 1F1B (non-interleaved when n_chunks == 1)."""
    warmup = min(pp - stage - 1, n_micro) if n_chunks == 1 else pp - stage - 1
    steps: list[Step] = []
    if n_chunks == 1:
        fwd = list(range(n_micro))
        bwd = list(range(n_micro))
        fi = bi = 0
        for _ in range(warmup):
            steps.append(("F", fwd[fi], 0))
            fi += 1
        while bi < n_micro:
            if fi < n_micro:
                steps.append(("F", fwd[fi], 0))
                fi += 1
            steps.append(("B", bwd[bi], 0))
            bi += 1
        return steps
    # interleaved: fall back to depth-first over chunks
    return sched_dfc(n_micro, n_chunks)


def sched_dfc(n_micro: int, n_chunks: int) -> list[Step]:
    """Depth-First Computation: same microbatch through all chunks first,
    backward as early as possible (low activation memory)."""
    steps: list[Step] = []
    for m in range(n_micro):
        for c in range(n_chunks):
            steps.append(("F", m, c))
        for c in reversed(range(n_chunks)):
            steps.append(("B", m, c))
    return steps


def sched_bfc(n_micro: int, n_chunks: int) -> list[Step]:
    """Breadth-First Computation: all microbatches through one chunk first —
    earlier gradient readiness per chunk, relaxed send deadlines, but the
    activation stash peaks at n_micro x n_chunks."""
    steps: list[Step] = []
    for c in range(n_chunks):
        for m in range(n_micro):
            steps.append(("F", m, c))
    for c in reversed(range(n_chunks)):
        for m in range(n_micro):
            steps.append(("B", m, c))
    return steps


SCHEDULES = {"1f1b": sched_1f1b, "dfc": sched_dfc, "bfc": sched_bfc}

#: Every named traversal ``make_order`` accepts — the simkit schedule
#: comparison surface (benchmarks sweep this list).  "zb" is the ZB-inspired
#: B/W split from ``core.dpp.schedule.sched_zb_split``; it is stage-dependent
#: like 1f1b.
SCHEDULE_NAMES = ("1f1b", "dfc", "bfc", "zb")


def make_order(
    schedule: str | list[Step],
    n_micro: int,
    n_chunks: int,
    pp: int,
    stage: int,
) -> list[Step]:
    if isinstance(schedule, list):
        return schedule
    if schedule == "1f1b":
        return sched_1f1b(n_micro, n_chunks, pp, stage)
    if schedule == "zb":
        # local import: dpp.schedule imports this module's primitives
        from repro_torch.core.dpp.schedule import sched_zb_split

        return sched_zb_split(n_micro, n_chunks, pp, stage)
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown schedule {schedule!r}; one of {SCHEDULE_NAMES}"
        )
    return SCHEDULES[schedule](n_micro, n_chunks)


def build_training_step(
    topo: Topology,
    prof: ModelProfile,
    *,
    n_micro: int,
    schedule: str | dict[int, list[Step]] = "1f1b",
    async_p2p: bool = False,
    tp_per_layer_colls: int = 2,
) -> dict[int, list[Task]]:
    """Lower one training iteration to per-rank ordered task lists.

    ``schedule`` is either a named traversal or a per-stage map of explicit
    (kind, microbatch, chunk) sequences (MegaDPP emits these).
    """
    order: dict[int, list[Task]] = {r: [] for r in range(topo.world)}

    def stage_steps(p: int) -> list[Step]:
        if isinstance(schedule, dict):
            return schedule[p]
        return make_order(schedule, n_micro, prof.n_chunks, topo.pp, p)

    # ZB-style schedules split backward into B (activation grad, on the
    # critical path) and W (weight grad, dependency-free filler)
    has_w = any(
        k == "W" for p in range(topo.pp) for (k, _, _) in stage_steps(p)
    )
    bwd_time = prof.bwd_time * (0.5 if has_w else 1.0)

    for d in range(topo.dp):
        for p in range(topo.pp):
            steps = stage_steps(p)
            for t in range(topo.tp):
                r = topo.rank(d, p, t)
                tp_group = tuple(topo.rank(d, p, tt) for tt in range(topo.tp))
                for kind, m, c in steps:
                    base = f"d{d}p{p}c{c}m{m}"
                    if kind == "F":
                        deps: list[str] = []
                        if p > 0:
                            deps.append(f"recvF_{base}_t{t}")
                            order[r].append(Task(
                                tid=f"recvF_{base}_t{t}", rank=r,
                                bytes=prof.p2p_bytes // topo.tp, kind="recv",
                                deps=(f"sendF_d{d}p{p-1}c{c}m{m}_t{t}",),
                                peer=topo.rank(d, p - 1, t),
                                blocking=not async_p2p,
                                meta={"mb": m, "chunk": c, "phase": "F"},
                            ))
                        order[r].append(Task(
                            tid=f"F_{base}_t{t}", rank=r,
                            duration=prof.fwd_time, kind="compute",
                            deps=tuple(deps),
                            alloc=prof.act_bytes,
                            meta={"mb": m, "chunk": c, "phase": "F", "op": "fwd"},
                        ))
                        if topo.tp > 1:
                            order[r].append(Task(
                                tid=f"arF_{base}_t{t}", rank=r,
                                bytes=prof.tp_bytes * tp_per_layer_colls,
                                kind="allreduce",
                                deps=(f"F_{base}_t{t}",),
                                coll_id=f"arF_{base}", group=tp_group,
                                meta={"mb": m, "chunk": c, "phase": "F"},
                            ))
                        if p < topo.pp - 1:
                            dep = (
                                f"arF_{base}_t{t}" if topo.tp > 1 else f"F_{base}_t{t}"
                            )
                            order[r].append(Task(
                                tid=f"sendF_{base}_t{t}", rank=r,
                                bytes=prof.p2p_bytes // topo.tp, kind="send",
                                deps=(dep,),
                                peer=topo.rank(d, p + 1, t),
                                blocking=not async_p2p,
                                meta={"mb": m, "chunk": c, "phase": "F"},
                            ))
                    elif kind == "W":  # deferred weight-grad (ZB filler)
                        order[r].append(Task(
                            tid=f"W_{base}_t{t}", rank=r,
                            duration=prof.bwd_time * 0.5, kind="compute",
                            deps=(f"B_{base}_t{t}",),
                            meta={"mb": m, "chunk": c, "phase": "W", "op": "wgrad"},
                        ))
                    else:  # backward
                        deps = [f"F_{base}_t{t}"]
                        if p < topo.pp - 1:
                            deps.append(f"recvB_{base}_t{t}")
                            order[r].append(Task(
                                tid=f"recvB_{base}_t{t}", rank=r,
                                bytes=prof.p2p_bytes // topo.tp, kind="recv",
                                deps=(f"sendB_d{d}p{p+1}c{c}m{m}_t{t}",),
                                peer=topo.rank(d, p + 1, t),
                                blocking=not async_p2p,
                                meta={"mb": m, "chunk": c, "phase": "B"},
                            ))
                        order[r].append(Task(
                            tid=f"B_{base}_t{t}", rank=r,
                            duration=bwd_time, kind="compute",
                            deps=tuple(deps),
                            free=prof.act_bytes,
                            meta={"mb": m, "chunk": c, "phase": "B", "op": "bwd"},
                        ))
                        if topo.tp > 1:
                            order[r].append(Task(
                                tid=f"arB_{base}_t{t}", rank=r,
                                bytes=prof.tp_bytes * tp_per_layer_colls,
                                kind="allreduce",
                                deps=(f"B_{base}_t{t}",),
                                coll_id=f"arB_{base}", group=tp_group,
                                meta={"mb": m, "chunk": c, "phase": "B"},
                            ))
                        if p > 0:
                            dep = (
                                f"arB_{base}_t{t}" if topo.tp > 1 else f"B_{base}_t{t}"
                            )
                            order[r].append(Task(
                                tid=f"sendB_{base}_t{t}", rank=r,
                                bytes=prof.p2p_bytes // topo.tp, kind="send",
                                deps=(dep,),
                                peer=topo.rank(d, p - 1, t),
                                blocking=not async_p2p,
                                meta={"mb": m, "chunk": c, "phase": "B"},
                            ))

    # DP gradient all-reduce (issued after the rank's last backward)
    if topo.dp > 1:
        for p in range(topo.pp):
            for t in range(topo.tp):
                for d in range(topo.dp):
                    r = topo.rank(d, p, t)
                    dp_group = tuple(topo.rank(dd, p, t) for dd in range(topo.dp))
                    last_b = [tt.tid for tt in order[r] if tt.kind == "compute"][-1]
                    order[r].append(Task(
                        tid=f"grad_ar_p{p}t{t}_d{d}", rank=r,
                        bytes=prof.grad_bytes, kind="allreduce",
                        deps=(last_b,),
                        coll_id=f"grad_ar_p{p}t{t}", group=dp_group,
                        meta={"phase": "G"},
                    ))
    return order
