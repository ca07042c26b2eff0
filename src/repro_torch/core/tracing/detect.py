"""Multi-stage straggler detection (MegaScan §3.2 "Anomaly analysis").

Core insight (paper): the true fault source is the slowest member of *every*
synchronous group it joins; collaterally-slowed ranks merely wait.

Stage 1 — cross-DP peer comparison: ranks with identical (pp, tp) coordinates
execute identical kernel sequences; per (op, microbatch, chunk, pp, tp) the
duration is compared across DP peers; ranks with an excessive fraction of
slow ops become candidates.

Stage 2 — collective start-skew: a genuine source *starts* its collectives
consistently later than peers (its preceding compute is slow).

Stage 3 — P2P effective bandwidth: payload/duration per directed edge;
degraded edges (impaired PCIe/NIC path) are flagged even when start-time
comparison is uninformative due to pipeline asynchrony.

A copy of ``repro.core.tracing.detect``; the port keeps its own, as it
imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from statistics import median

from repro_torch.core.simkit.workload import Topology
from repro_torch.core.tracing.align import CollectiveInstance, reconstruct_collectives
from repro_torch.core.tracing.events import TraceEvent


@dataclass
class Diagnosis:
    slow_ranks: list[int]
    candidate_ranks: list[int]
    degraded_links: list[tuple[int, int]]
    rank_scores: dict[int, dict] = field(default_factory=dict)
    link_bandwidth: dict[tuple[int, int], float] = field(default_factory=dict)
    evidence: dict = field(default_factory=dict)

    def summary(self) -> dict:
        return {
            "slow_ranks": self.slow_ranks,
            "candidates": self.candidate_ranks,
            "degraded_links": [list(l) for l in self.degraded_links],
            "rank_scores": {str(k): v for k, v in self.rank_scores.items()},
        }


def _stage1_peer_comparison(
    events: list[TraceEvent], topo: Topology, slow_ratio: float
) -> dict[int, float]:
    """Fraction of a rank's compute ops that are slow vs its DP peers."""
    groups: dict[tuple, dict[int, float]] = defaultdict(dict)
    for e in events:
        if e.kind != "compute":
            continue
        d, p, t = topo.coords(e.rank)
        key = (p, t, e.args.get("op", e.name), e.args.get("mb"), e.args.get("chunk"))
        groups[key][e.rank] = groups[key].get(e.rank, 0.0) + e.dur

    slow_count: dict[int, int] = defaultdict(int)
    total_count: dict[int, int] = defaultdict(int)
    for key, per_rank in groups.items():
        if len(per_rank) < 2:
            continue
        # statistics.median: the groups are tiny (one value per DP peer),
        # where numpy's per-call overhead dominates the online pass
        med = float(median(per_rank.values()))
        for r, dur in per_rank.items():
            total_count[r] += 1
            if dur > slow_ratio * med:
                slow_count[r] += 1
    return {
        r: slow_count[r] / total_count[r] for r in total_count if total_count[r] > 0
    }


def _stage2_start_skew(
    instances: list[CollectiveInstance], skew_margin: float
) -> dict[int, float]:
    """Fraction of collectives in which the rank is the distinctly-last
    starter (evidence it is the source rather than a victim)."""
    late: dict[int, int] = defaultdict(int)
    total: dict[int, int] = defaultdict(int)
    for inst in instances:
        if len(inst.members) < 2:
            continue
        starts = inst.starts
        order = sorted(starts.items(), key=lambda kv: kv[1])
        last_rank, last_t = order[-1]
        second_t = order[-2][1]
        span = max(inst.members[last_rank].dur, 1e-9)
        for r in starts:
            total[r] += 1
        if (last_t - second_t) > skew_margin * span:
            late[last_rank] += 1
    return {r: late[r] / total[r] for r in total if total[r]}


def _stage3_p2p_bandwidth(
    events: list[TraceEvent], degrade_ratio: float, warmup_only: bool = False
) -> tuple[dict[tuple[int, int], float], list[tuple[int, int]]]:
    per_edge: dict[tuple[int, int], list[float]] = defaultdict(list)
    for e in events:
        if e.kind != "p2p" or e.args.get("dir") != "send":
            continue
        if warmup_only and e.args.get("mb", 0) > 0:
            continue
        peer = e.args.get("peer")
        nbytes = e.args.get("bytes", 0)
        if peer is None or not nbytes or e.dur <= 0:
            continue
        per_edge[(e.rank, peer)].append(nbytes / e.dur)

    bw = {edge: float(median(v)) for edge, v in per_edge.items() if v}
    if not bw:
        return {}, []
    global_med = float(median(bw.values()))
    degraded = [e for e, b in bw.items() if b < global_med / degrade_ratio]
    return bw, degraded


def detect(
    events: list[TraceEvent],
    topo: Topology,
    *,
    slow_ratio: float = 1.25,
    candidate_frac: float = 0.25,
    skew_margin: float = 0.05,
    late_frac: float = 0.4,
    degrade_ratio: float = 1.6,
    instances: list[CollectiveInstance] | None = None,
) -> Diagnosis:
    if instances is None:
        instances = reconstruct_collectives(events)

    slow_frac = _stage1_peer_comparison(events, topo, slow_ratio)
    candidates = sorted(r for r, f in slow_frac.items() if f >= candidate_frac)

    late = _stage2_start_skew(instances, skew_margin)
    confirmed = sorted(
        r for r in candidates if late.get(r, 0.0) >= late_frac
    )
    # Degenerate-but-real case: every DP peer group has exactly one member
    # (dp=1) — stage 1 is silent, fall back to stage-2 evidence alone.
    if not slow_frac and late:
        confirmed = sorted(r for r, f in late.items() if f >= max(late_frac, 0.6))

    bw, degraded = _stage3_p2p_bandwidth(events, degrade_ratio)

    scores = {}
    for r in set(list(slow_frac) + list(late)):
        scores[r] = {
            "slow_op_frac": round(slow_frac.get(r, 0.0), 4),
            "late_start_frac": round(late.get(r, 0.0), 4),
        }
    return Diagnosis(
        slow_ranks=confirmed,
        candidate_ranks=candidates,
        degraded_links=sorted(degraded),
        rank_scores=scores,
        link_bandwidth=bw,
        evidence={"n_instances": len(instances), "n_events": len(events)},
    )
