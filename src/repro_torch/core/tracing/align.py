"""Dependency reconstruction + cross-rank clock alignment (MegaScan §3.2).

Dependency reconstruction: events of the *same* synchronous communication
instance are matched by (participant-set, op) occurrence order — each rank's
i-th event for a given group key belongs to instance i (the paper's
"single pass over the events").

Timeline alignment: all participants of a synchronous collective logically
finish at the same moment, so every matched instance is an anchor.  We fit a
per-rank linear clock model offset_r(t) = a_r + b_r * t against a reference
rank by least squares over anchors (offset + drift), then optionally apply a
piecewise correction between consecutive anchors so residual error stays
bounded by the inter-anchor interval — dense collectives (TP traffic) give
dense anchors and correspondingly tight alignment.

A copy of ``repro.core.tracing.align``; the port keeps its own, as it
imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.tracing.events import TraceEvent


@dataclass
class CollectiveInstance:
    key: tuple              # (group ranks, op name)
    seq: int                # occurrence index
    members: dict[int, TraceEvent]  # rank -> event

    @property
    def ends(self) -> dict[int, float]:
        return {r: e.end for r, e in self.members.items()}

    @property
    def starts(self) -> dict[int, float]:
        return {r: e.ts for r, e in self.members.items()}


def reconstruct_collectives(events: list[TraceEvent]) -> list[CollectiveInstance]:
    per_key: dict[tuple, dict[int, list[TraceEvent]]] = defaultdict(lambda: defaultdict(list))
    for e in events:
        if e.kind != "coll":
            continue
        group = tuple(e.args.get("group", ()))
        if not group:
            continue
        key = (group, e.args.get("op", e.name.split("#")[0]))
        per_key[key][e.rank].append(e)
    for ranks in per_key.values():
        for lst in ranks.values():
            lst.sort(key=lambda e: e.ts)

    out: list[CollectiveInstance] = []
    for key, ranks in per_key.items():
        n = min(len(v) for v in ranks.values())
        if set(ranks) != set(key[0]):
            # missing members: match only ranks that logged events
            pass
        for i in range(n):
            out.append(CollectiveInstance(key, i, {r: v[i] for r, v in ranks.items()}))
    # annotate events with their instance id (related_sync_op)
    for idx, inst in enumerate(out):
        for e in inst.members.values():
            e.args["related_sync_op"] = idx
    return out


@dataclass
class Alignment:
    """Per-rank clock correction: local_time -> global_time."""
    linear: dict[int, tuple[float, float]]              # rank -> (a, b)
    anchors: dict[int, np.ndarray] = field(default_factory=dict)   # rank -> [n,2] (t_local, resid)

    def correct(self, rank: int, t: float | np.ndarray):
        a, b = self.linear.get(rank, (0.0, 0.0))
        t = np.asarray(t, dtype=np.float64)
        g = t - (a + b * t)
        anc = self.anchors.get(rank)
        if anc is not None and len(anc) >= 2:
            g = g - np.interp(t, anc[:, 0], anc[:, 1])
        return g


def align_clocks(
    events: list[TraceEvent],
    ref_rank: int = 0,
    *,
    piecewise: bool = True,
    instances: list[CollectiveInstance] | None = None,
) -> Alignment:
    if instances is None:
        instances = reconstruct_collectives(events)

    # anchor observations: rank r's event end vs the instance's consensus end.
    # Consensus = min over members (the true completion is when the slowest
    # arrives; offsets shift each observation, min is a robust first pass,
    # then we iterate once against the corrected consensus).
    ranks = sorted({e.rank for e in events})
    obs: dict[int, list[tuple[float, float]]] = {r: [] for r in ranks}

    # iteration 0: offsets zero; consensus = median of member ends
    lin = {r: (0.0, 0.0) for r in ranks}
    for _ in range(3):
        for r in ranks:
            obs[r] = []
        for inst in instances:
            if len(inst.members) < 2:
                continue
            corr_ends = {
                r: e.end - (lin[r][0] + lin[r][1] * e.end)
                for r, e in inst.members.items()
            }
            consensus = float(np.median(list(corr_ends.values())))
            for r, e in inst.members.items():
                # local end - consensus ~= a_r + b_r * t  (in local time)
                obs[r].append((e.end, e.end - consensus - 0.0))
        new_lin = {}
        for r in ranks:
            if r == ref_rank or not obs[r]:
                new_lin[r] = (0.0, 0.0)
                continue
            pts = np.asarray(obs[r], dtype=np.float64)
            t, d = pts[:, 0], pts[:, 1]
            if len(pts) >= 2 and (t.max() - t.min()) > 1e-9:
                A = np.stack([np.ones_like(t), t], axis=1)
                coef, *_ = np.linalg.lstsq(A, d, rcond=None)
                new_lin[r] = (float(coef[0]), float(coef[1]))
            else:
                new_lin[r] = (float(np.median(d)), 0.0)
        # re-reference so ref_rank is exactly zero
        lin = new_lin

    align = Alignment(linear=lin)
    if piecewise:
        for r in ranks:
            if r == ref_rank or not obs[r]:
                continue
            pts = np.asarray(sorted(obs[r]), dtype=np.float64)
            t = pts[:, 0]
            a, b = lin[r]
            resid = pts[:, 1] - (a + b * t)
            # moving-median residual as the piecewise correction
            if len(t) >= 4:
                k = max(len(t) // 16, 1)
                sm = np.convolve(resid, np.ones(2 * k + 1) / (2 * k + 1), mode="same")
                align.anchors[r] = np.stack([t, sm], axis=1)
    return align


def apply_alignment(events: list[TraceEvent], align: Alignment) -> list[TraceEvent]:
    out = []
    for e in events:
        ts = float(align.correct(e.rank, e.ts))
        te = float(align.correct(e.rank, e.end))
        out.append(TraceEvent(e.name, e.rank, ts, max(te - ts, 0.0), e.kind, dict(e.args)))
    return out
