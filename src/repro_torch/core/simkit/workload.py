"""Task-graph builders for the discrete-event engine, copied from
``repro.core.simkit.workload``.

Training: one 3-D-parallel (DP x PP x TP) iteration.  The pipeline traversal
order is pluggable — MegaDPP's scheduler emits the (model_chunk, microbatch)
visit order per rank (DFC / BFC / 1F1B / custom) and this module lowers it
into engine tasks: stage compute (with per-layer TP collectives folded in),
inter-stage P2P sends/recvs, and the DP gradient all-reduce after the last
backward.  Rank layout follows Megatron order:
rank = dp * (PP*TP) + pp * TP + tp.

Serving: ``serving_workload`` lowers a MegaServe request trace (Poisson,
bursty or diurnal arrivals, mixed lengths) under a batching policy —
"continuous" (slot admission + immediate refill; an idealized pool-less
model of ``repro_torch.serve.scheduler`` that admits into every free slot
per tick and never preempts) or "static" (length-bucketed lockstep batches,
mirroring ``repro_torch.serve.server.StaticRunner``) — into engine tasks, so
scheduler policies can be evaluated offline, on the host alone.
Request ``i``'s arrival is modeled as a duration-``arrival`` task on virtual
rank ``1 + i``; serving compute lives on rank 0 and every admission depends
on the matching arrival task.

MegaRoute: ``PlacementView``, ``estimate_ttft``, the placement policies,
``admission_decision`` and the offline ``router_workload`` /
``router_summary`` evaluator; the live router
(``repro_torch.serve.router``) calls the same decision functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

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


# ---------------------------------------------------------------------------
# MegaServe: offline serving-policy evaluation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RequestSpec:
    rid: int
    arrival: float          # seconds
    prompt_len: int
    max_new: int


@dataclass(frozen=True)
class ServeProfile:
    """Serving cost model (seconds)."""

    prefill_time_per_token: float = 50e-6
    decode_step_base: float = 2e-3       # fixed cost of one engine step
    decode_step_per_seq: float = 0.2e-3  # marginal cost per active slot


def poisson_requests(
    n: int,
    rate: float,
    *,
    prompt_lens: Sequence[int] = (16, 32, 64, 128, 256),
    max_new_range: tuple[int, int] = (4, 48),
    seed: int = 0,
) -> list[RequestSpec]:
    """Poisson arrivals at ``rate``/s with mixed prompt/generation lengths;
    ``max_new_range`` is inclusive on both ends."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        out.append(RequestSpec(
            rid=i,
            arrival=t,
            prompt_len=int(rng.choice(prompt_lens)),
            max_new=int(rng.integers(*max_new_range, endpoint=True)),
        ))
    return out


def _spec_of(rng, i: int, t: float, prompt_lens, max_new_range) -> RequestSpec:
    return RequestSpec(
        rid=i,
        arrival=t,
        prompt_len=int(rng.choice(prompt_lens)),
        max_new=int(rng.integers(*max_new_range, endpoint=True)),
    )


def bursty_requests(
    n: int,
    rate: float,
    *,
    burst_mult: float = 8.0,
    burst_frac: float = 0.2,
    burst_dwell_s: float = 0.2,
    prompt_lens: Sequence[int] = (16, 32, 64, 128, 256),
    max_new_range: tuple[int, int] = (4, 48),
    seed: int = 0,
) -> list[RequestSpec]:
    """Markov-modulated Poisson arrivals (MMPP-2): the process alternates
    between a *calm* state and a *burst* state whose rate is ``burst_mult``
    times higher, with exponential dwell times sized so a ``burst_frac``
    fraction of time is spent bursting and the long-run average rate is
    ``rate``/s.  Inter-arrival CV > 1 for any ``burst_mult`` > 1 — the
    traffic shape that separates load-aware routing policies from
    round-robin (a burst lands on whichever replica is unlucky).
    """
    import numpy as np

    if burst_mult <= 1.0 or not (0.0 < burst_frac < 1.0):
        raise ValueError(
            f"bursty_requests needs burst_mult > 1 and 0 < burst_frac < 1 "
            f"(got {burst_mult}, {burst_frac})"
        )
    rng = np.random.default_rng(seed)
    calm_rate = rate / (1.0 - burst_frac + burst_frac * burst_mult)
    rates = (calm_rate, calm_rate * burst_mult)
    # exponential state-holding times with the stationary split burst_frac
    dwell = (burst_dwell_s * (1.0 - burst_frac) / burst_frac, burst_dwell_s)
    state = 0
    t = 0.0
    t_switch = float(rng.exponential(dwell[state]))
    out: list[RequestSpec] = []
    while len(out) < n:
        dt = float(rng.exponential(1.0 / rates[state]))
        if t + dt >= t_switch:
            # no arrival before the state flips: restart the (memoryless)
            # exponential clock at the switch with the new state's rate
            t = t_switch
            state = 1 - state
            t_switch = t + float(rng.exponential(dwell[state]))
            continue
        t += dt
        out.append(_spec_of(rng, len(out), t, prompt_lens, max_new_range))
    return out


def diurnal_requests(
    n: int,
    rate: float,
    *,
    period_s: float = 10.0,
    depth: float = 0.8,
    prompt_lens: Sequence[int] = (16, 32, 64, 128, 256),
    max_new_range: tuple[int, int] = (4, 48),
    seed: int = 0,
) -> list[RequestSpec]:
    """Non-homogeneous Poisson arrivals whose rate follows a sinusoid —
    ``rate(t) = rate * (1 + depth * sin(2 pi t / period_s))`` — the
    compressed "millions of users across timezones" diurnal cycle.  Sampled
    by thinning against the peak rate, so the realized arrival density
    tracks the sinusoid exactly in expectation.
    """
    import math

    import numpy as np

    if not (0.0 < depth <= 1.0):
        raise ValueError(f"diurnal depth must be in (0, 1], got {depth}")
    rng = np.random.default_rng(seed)
    peak = rate * (1.0 + depth)
    t = 0.0
    out: list[RequestSpec] = []
    while len(out) < n:
        t += float(rng.exponential(1.0 / peak))
        lam = rate * (1.0 + depth * math.sin(2.0 * math.pi * t / period_s))
        if float(rng.uniform()) * peak <= lam:
            out.append(_spec_of(rng, len(out), t, prompt_lens, max_new_range))
    return out


def serving_workload(
    requests: Sequence[RequestSpec],
    *,
    policy: str = "continuous",
    num_slots: int = 4,
    batch_size: int | None = None,
    prof: ServeProfile = ServeProfile(),
) -> dict[int, list[Task]]:
    """Lower a request trace under a batching policy to engine task lists.

    The policy decisions (admission order, batch formation) are simulated
    here against ``prof``; the engine then reproduces the timeline from the
    emitted dependency structure, so altering link/fault models or profiles
    re-times the same policy.  Decode tasks carry ``meta={"tokens": k}`` =
    useful tokens emitted that step; sum them for throughput.
    """
    arrive = {
        r.rid: Task(
            tid=f"arrive_r{r.rid}", rank=1 + i, duration=r.arrival,
            kind="compute", meta={"phase": "arrive", "rid": r.rid},
        )
        for i, r in enumerate(requests)
    }
    serve: list[Task] = []
    reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))

    if policy == "continuous":
        now = 0.0
        waiting = list(reqs)
        slots: dict[int, list] = {}      # slot -> [rid, remaining]
        step = 0
        while waiting or slots:
            if not slots and waiting and waiting[0].arrival > now:
                now = waiting[0].arrival
            free = [s for s in range(num_slots) if s not in slots]
            for s in free:
                nxt = next((r for r in waiting if r.arrival <= now), None)
                if nxt is None:
                    break
                waiting.remove(nxt)
                dur = nxt.prompt_len * prof.prefill_time_per_token
                serve.append(Task(
                    tid=f"prefill_r{nxt.rid}", rank=0, duration=dur,
                    kind="compute", deps=(f"arrive_r{nxt.rid}",),
                    meta={"phase": "prefill", "rid": nxt.rid, "tokens": 1},
                ))
                now = max(now, nxt.arrival) + dur
                # prefill emits the first token; remaining decode budget:
                slots[s] = [nxt.rid, nxt.max_new - 1]
                if slots[s][1] <= 0:
                    del slots[s]
            if slots:
                active = len(slots)
                dur = prof.decode_step_base + active * prof.decode_step_per_seq
                serve.append(Task(
                    tid=f"dec{step}", rank=0, duration=dur, kind="compute",
                    meta={"phase": "decode", "active": active, "tokens": active},
                ))
                now += dur
                for s in list(slots):
                    slots[s][1] -= 1
                    if slots[s][1] <= 0:
                        del slots[s]
            step += 1
    elif policy == "static":
        # mirrors server.StaticRunner: length-bucketed batches (one prompt
        # length per batch, so no padding cost), buckets processed in
        # ascending length, batch members in arrival order, launch gated on
        # the last member's arrival, lockstep to the slowest budget
        B = batch_size or num_slots
        buckets: dict[int, list[RequestSpec]] = {}
        for r in reqs:
            buckets.setdefault(r.prompt_len, []).append(r)
        b = 0
        for plen in sorted(buckets):
            group = buckets[plen]
            for bi in range(0, len(group), B):
                members = group[bi : bi + B]
                steps = max(r.max_new for r in members)
                serve.append(Task(
                    tid=f"prefill_b{b}", rank=0,
                    duration=len(members) * plen * prof.prefill_time_per_token,
                    kind="compute",
                    deps=tuple(f"arrive_r{r.rid}" for r in members),
                    meta={"phase": "prefill", "batch": b,
                          "tokens": len(members)},
                ))
                for s in range(steps - 1):
                    useful = sum(1 for r in members if r.max_new - 1 > s)
                    serve.append(Task(
                        tid=f"dec_b{b}_s{s}", rank=0,
                        duration=prof.decode_step_base
                        + len(members) * prof.decode_step_per_seq,
                        kind="compute",
                        meta={"phase": "decode", "active": len(members),
                              "tokens": useful},
                    ))
                b += 1
    else:
        raise ValueError(f"unknown serving policy {policy!r}")

    return {0: serve, **{t.rank: [t] for t in arrive.values()}}


def serving_throughput(result) -> dict:
    """Aggregate tokens/s + makespan from a ``serving_workload`` run."""
    tokens = sum(
        r.meta.get("tokens", 0) for r in result.records if r.rank == 0
    )
    return {
        "tokens": tokens,
        "makespan": result.makespan,
        "tokens_per_s": tokens / result.makespan if result.makespan else 0.0,
    }


# ---------------------------------------------------------------------------
# MegaRoute: placement policies + SLO-aware admission (shared with the live
# router — ``repro_torch.serve.router`` imports these, so the offline simkit
# evaluation and the online router run ONE implementation of the decision
# logic; this module must not import ``repro_torch.serve``)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlacementView:
    """One replica's load snapshot, as the placement policies see it."""

    queued: int                  # requests waiting for a slot
    queued_prefill_tokens: int   # prompt tokens ahead in that queue
    active: int                  # slots currently decoding
    kv_used_frac: float          # physical KV pool occupancy in [0, 1]


def estimate_ttft(
    view: PlacementView, prompt_len: int, prof: ServeProfile = ServeProfile()
) -> float:
    """Predicted TTFT if a ``prompt_len`` request were enqueued on ``view``'s
    replica now: the prefill work ahead of it (queued prompts + its own)
    plus one engine tick per queued request ahead (admission is one-per-tick
    shaped) at the replica's current decode cost."""
    prefill = (
        (view.queued_prefill_tokens + prompt_len) * prof.prefill_time_per_token
    )
    tick = prof.decode_step_base + view.active * prof.decode_step_per_seq
    return prefill + (view.queued + 1) * tick


def _place_round_robin(views: Sequence[PlacementView], rr: int) -> int:
    return rr % len(views)


def _place_least_kv(views: Sequence[PlacementView], rr: int) -> int:
    return min(
        range(len(views)),
        key=lambda i: (views[i].kv_used_frac, views[i].queued, i),
    )


def _place_jsq(views: Sequence[PlacementView], rr: int) -> int:
    return min(
        range(len(views)),
        key=lambda i: (views[i].queued + views[i].active, i),
    )


#: Placement policies: view snapshots + a round-robin cursor -> replica index.
POLICIES = {
    "round_robin": _place_round_robin,
    "least_kv": _place_least_kv,
    "jsq": _place_jsq,
}


def place(policy: str, views: Sequence[PlacementView], rr: int = 0) -> int:
    if policy not in POLICIES:
        raise ValueError(
            f"unknown router policy {policy!r}; one of {sorted(POLICIES)}"
        )
    return POLICIES[policy](views, rr)


def admission_decision(
    policy: str,
    views: Sequence[PlacementView],
    prompt_len: int,
    *,
    prof: ServeProfile = ServeProfile(),
    rr: int = 0,
    slo_ttft_s: float = 0.0,
    shed: bool = True,
) -> tuple[str, int, float]:
    """SLO-aware admission: returns ``(action, replica, estimated_ttft)``
    with action one of ``admit`` (the policy's pick meets the SLO, or no SLO
    is set), ``redirect`` (the pick would bust it but another replica
    doesn't), or ``shed`` (every replica busts it and shedding is enabled;
    with ``shed=False`` the request is admitted on the least-bad replica)."""
    primary = place(policy, views, rr)
    est = estimate_ttft(views[primary], prompt_len, prof)
    if slo_ttft_s <= 0 or est <= slo_ttft_s:
        return "admit", primary, est
    best = min(
        range(len(views)),
        key=lambda i: estimate_ttft(views[i], prompt_len, prof),
    )
    best_est = estimate_ttft(views[best], prompt_len, prof)
    if best != primary and best_est <= slo_ttft_s:
        return "redirect", best, best_est
    if shed:
        return "shed", best, best_est
    return "admit", best, best_est


class _ReplicaSim:
    """One replica of ``router_workload``: the continuous-batching tick
    model of ``serving_workload`` plus the KV-pool dynamics that make
    placement matter — optimistic admission (a prompt admits whenever its
    prefill footprint fits) and preemption-by-recompute when decode growth
    overruns ``kv_capacity_tokens``, mirroring ``repro_torch.serve.scheduler``.
    An occupancy-blind policy that keeps stuffing a hot replica pays the
    recompute amplification; that is the tail ``least_kv``/``jsq`` avoid.
    Advanced event-driven to each arrival so placement sees load snapshots
    at decision time."""

    def __init__(self, idx: int, num_slots: int, prof: ServeProfile,
                 kv_capacity_tokens: int, speed: float = 1.0):
        self.idx = idx
        self.prof = prof
        self.num_slots = num_slots
        self.kv_cap = kv_capacity_tokens
        self.speed = speed
        self.now = 0.0
        # waiting: [rid, arrival, prefill_tokens, emit_left, first_admission]
        self.waiting: list[list] = []
        # slots: slot -> [rid, emit_left, held_tokens, admit_seq]
        self.slots: dict[int, list] = {}
        self.tasks: list[Task] = []
        self.step = 0
        self.preemptions = 0
        self._seq = 0

    def enqueue(self, spec: RequestSpec) -> None:
        self.waiting.append(
            [spec.rid, spec.arrival, spec.prompt_len, spec.max_new, True])

    def _held(self) -> int:
        return sum(st[2] for st in self.slots.values())

    def view(self) -> PlacementView:
        return PlacementView(
            queued=len(self.waiting),
            queued_prefill_tokens=sum(e[2] for e in self.waiting),
            active=len(self.slots),
            kv_used_frac=self._held() / max(self.kv_cap, 1),
        )

    def _tick(self) -> None:
        for s in [s for s in range(self.num_slots) if s not in self.slots]:
            if not self.waiting:
                break
            rid, arr, ptoks, emit_left, first = self.waiting[0]
            if self.slots and self._held() + ptoks + 1 > self.kv_cap:
                break   # FIFO head-of-line, like the live admit loop
            self.waiting.pop(0)
            dur = ptoks * self.prof.prefill_time_per_token / self.speed
            done = [rid] if emit_left <= 1 else []
            self.tasks.append(Task(
                tid=f"prefill_r{rid}_{self.step}s{s}", rank=self.idx,
                duration=dur, kind="compute", deps=(f"arrive_r{rid}",),
                meta={"phase": "prefill", "rid": rid, "replica": self.idx,
                      "arrival": arr, "first": first, "tokens": 1,
                      "finished": done},
            ))
            self.now += dur
            if not done:  # the prefill emitted one token already
                self._seq += 1
                self.slots[s] = [rid, emit_left - 1, ptoks + 1, self._seq]
        if self.slots:
            active = len(self.slots)
            dur = (self.prof.decode_step_base
                   + active * self.prof.decode_step_per_seq) / self.speed
            fin, pre = [], []
            for s in list(self.slots):
                st = self.slots[s]
                st[1] -= 1
                st[2] += 1
                if st[1] <= 0:
                    fin.append(st[0])
                    del self.slots[s]
            # pool overrun: preempt youngest-admitted slots (LIFO, like
            # Scheduler.ensure_capacity); their held tokens recompute later
            while self._held() > self.kv_cap and len(self.slots) > 1:
                s = max(self.slots, key=lambda k: self.slots[k][3])
                rid_p, emit_left_p, held_p, _ = self.slots.pop(s)
                self.waiting.insert(0, [rid_p, 0.0, held_p, emit_left_p, False])
                pre.append(rid_p)
                self.preemptions += 1
            self.tasks.append(Task(
                tid=f"dec_n{self.idx}_s{self.step}", rank=self.idx,
                duration=dur, kind="compute",
                meta={"phase": "decode", "replica": self.idx,
                      "active": active, "tokens": active, "finished": fin,
                      "preempted": pre},
            ))
            self.now += dur
        self.step += 1

    def advance_to(self, t: float) -> None:
        while self.waiting or self.slots:
            if self.now >= t:
                return
            self._tick()
        self.now = max(self.now, t)


def router_workload(
    requests: Sequence[RequestSpec],
    *,
    policy: str = "round_robin",
    n_replicas: int = 2,
    num_slots: int = 4,
    prof: ServeProfile = ServeProfile(),
    slo_ttft_s: float = 0.0,
    shed: bool = True,
    kv_capacity_tokens: int = 2048,
    replica_speeds: Sequence[float] | None = None,
) -> dict[int, list[Task]]:
    """Lower a request trace through MegaRoute's placement + admission onto
    ``n_replicas`` idealized replicas, as engine task lists — the offline
    policy-evaluation surface (same ``admission_decision`` the live router
    calls).  Ranks: replica ``r`` -> rank ``r``; request ``i``'s arrival ->
    rank ``n_replicas + i``; a shed request becomes a zero-duration ``shed``
    task on its arrival rank, so every request either finishes on a replica
    (``finished`` rid lists on prefill/decode tasks) or is counted shed —
    the conservation law ``router_summary`` checks.  ``replica_speeds``
    models heterogeneous/degraded replicas (a 0.5 entry runs at half speed
    — the straggler-replica scenario where load-aware placement separates
    from round-robin)."""
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    speeds = list(replica_speeds) if replica_speeds else [1.0] * n_replicas
    if len(speeds) != n_replicas:
        raise ValueError(
            f"replica_speeds has {len(speeds)} entries for {n_replicas} replicas"
        )
    reps = [_ReplicaSim(i, num_slots, prof, kv_capacity_tokens, speeds[i])
            for i in range(n_replicas)]
    arrive: dict[int, list[Task]] = {}
    shed_tasks: dict[int, list[Task]] = {}
    rr = 0
    for i, spec in enumerate(sorted(requests, key=lambda r: (r.arrival, r.rid))):
        rank = n_replicas + i
        arrive[rank] = [Task(
            tid=f"arrive_r{spec.rid}", rank=rank, duration=spec.arrival,
            kind="compute", meta={"phase": "arrive", "rid": spec.rid},
        )]
        for rep in reps:
            rep.advance_to(spec.arrival)
        action, idx, est = admission_decision(
            policy, [rep.view() for rep in reps], spec.prompt_len,
            prof=prof, rr=rr, slo_ttft_s=slo_ttft_s, shed=shed,
        )
        rr += 1
        if action == "shed":
            shed_tasks.setdefault(rank, []).append(Task(
                tid=f"shed_r{spec.rid}", rank=rank, duration=0.0,
                kind="compute", deps=(f"arrive_r{spec.rid}",),
                meta={"phase": "shed", "rid": spec.rid, "est_ttft": est},
            ))
            continue
        reps[idx].enqueue(spec)
    for rep in reps:
        rep.advance_to(float("inf"))
    out = {rep.idx: rep.tasks for rep in reps}
    for rank, tasks in arrive.items():
        out[rank] = tasks + shed_tasks.get(rank, [])
    return out


def router_summary(result, *, n_replicas: int) -> dict:
    """Digest a ``router_workload`` engine run: TTFT percentiles (prefill
    task end minus arrival), shed/finished rid sets (conservation: their
    union must cover every submitted rid), and per-replica token counts
    (load skew)."""

    def pct(xs: list[float], q: float) -> float:
        if not xs:
            return 0.0
        ys = sorted(xs)
        return ys[max(0, min(len(ys) - 1, int(round(q / 100 * (len(ys) - 1)))))]

    submitted: set[int] = set()
    finished: set[int] = set()
    shed: set[int] = set()
    ttfts: list[float] = []
    preemptions = 0
    replica_tokens = [0] * n_replicas
    for rec in result.records:
        phase = rec.meta.get("phase")
        if phase == "arrive":
            submitted.add(rec.meta["rid"])
        elif phase == "shed":
            shed.add(rec.meta["rid"])
        elif phase == "prefill":
            if rec.meta.get("first", True):
                ttfts.append(rec.end - rec.meta["arrival"])
            finished.update(rec.meta.get("finished", ()))
            replica_tokens[rec.rank] += rec.meta.get("tokens", 0)
        elif phase == "decode":
            finished.update(rec.meta.get("finished", ()))
            preemptions += len(rec.meta.get("preempted", ()))
            replica_tokens[rec.rank] += rec.meta.get("tokens", 0)
    skew = (
        max(replica_tokens) / max(min(replica_tokens), 1)
        if replica_tokens else 1.0
    )
    return {
        "submitted": len(submitted),
        "finished": len(finished),
        "shed": len(shed),
        "conserved": submitted == (finished | shed),
        "shed_rate": len(shed) / max(len(submitted), 1),
        "ttft_p50_s": pct(ttfts, 50),
        "ttft_p99_s": pct(ttfts, 99),
        "preemptions": preemptions,
        "replica_tokens": replica_tokens,
        "load_skew": skew,
        "makespan": result.makespan,
    }
