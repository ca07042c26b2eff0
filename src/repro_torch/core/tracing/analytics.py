"""In-memory columnar trace analytics (MegaScan §3.2 "Fast data retrieval").

The paper loads the merged Chrome trace into Perfetto and runs SQL; offline we
provide the equivalent queries over numpy columns.  The exported trace.json
stays Perfetto-compatible, so the paper's interop path also works.

A copy of ``repro.core.tracing.analytics``; the port keeps its own, as it
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.tracing.events import TraceEvent


@dataclass
class TraceTable:
    rank: np.ndarray
    ts: np.ndarray
    dur: np.ndarray
    kind: np.ndarray          # unicode
    name: np.ndarray
    nbytes: np.ndarray
    peer: np.ndarray          # -1 when absent
    mb: np.ndarray            # microbatch, -1 when absent
    phase: np.ndarray

    def __len__(self) -> int:
        return len(self.ts)

    def where(self, mask: np.ndarray) -> "TraceTable":
        return TraceTable(**{
            k: getattr(self, k)[mask] for k in self.__dataclass_fields__
        })


def to_table(events: list[TraceEvent]) -> TraceTable:
    n = len(events)
    get = lambda e, k, d: e.args.get(k, d)
    return TraceTable(
        rank=np.array([e.rank for e in events], np.int32),
        ts=np.array([e.ts for e in events], np.float64),
        dur=np.array([e.dur for e in events], np.float64),
        kind=np.array([e.kind for e in events]),
        name=np.array([e.name for e in events]),
        nbytes=np.array([get(e, "bytes", 0) for e in events], np.int64),
        peer=np.array([get(e, "peer", -1) for e in events], np.int32),
        mb=np.array([get(e, "mb", -1) for e in events], np.int32),
        phase=np.array([str(get(e, "phase", "")) for e in events]),
    )


# --------------------------------------------------------------- queries ---


def bandwidth_by_edge(t: TraceTable) -> dict[tuple[int, int], dict]:
    """SELECT src, dst, median(bytes/dur), count(*) FROM p2p GROUP BY edge."""
    m = (t.kind == "p2p") & (t.nbytes > 0) & (t.dur > 0) & (t.peer >= 0)
    out: dict[tuple[int, int], list[float]] = {}
    for r, p, b, d in zip(t.rank[m], t.peer[m], t.nbytes[m], t.dur[m]):
        out.setdefault((int(r), int(p)), []).append(b / d)
    return {
        e: {"median_bps": float(np.median(v)), "n": len(v),
            "min_bps": float(np.min(v))}
        for e, v in out.items()
    }


def utilization_by_rank(t: TraceTable) -> dict[int, dict]:
    """Busy-time fractions per rank, split compute vs communication."""
    span = t.ts.max() + t.dur.max() - t.ts.min() if len(t) else 1.0
    out = {}
    for r in np.unique(t.rank):
        m = t.rank == r
        comp = float(t.dur[m & (t.kind == "compute")].sum())
        comm = float(t.dur[m & ((t.kind == "coll") | (t.kind == "p2p"))].sum())
        out[int(r)] = {
            "compute_frac": comp / span,
            "comm_frac": comm / span,
            "idle_frac": max(0.0, 1.0 - (comp + comm) / span),
        }
    return out


def slow_ops(t: TraceTable, ratio: float = 1.5) -> list[dict]:
    """Ops >= ratio x the median duration of their (name-class) group."""
    base = np.array([n.split("_")[0] for n in t.name])
    rows = []
    for cls in np.unique(base):
        m = (base == cls) & (t.kind == "compute")
        if m.sum() < 3:
            continue
        med = float(np.median(t.dur[m]))
        for i in np.nonzero(m)[0]:
            if t.dur[i] > ratio * med:
                rows.append({
                    "name": str(t.name[i]), "rank": int(t.rank[i]),
                    "dur": float(t.dur[i]), "median": med,
                    "ratio": float(t.dur[i] / med),
                })
    return sorted(rows, key=lambda r: -r["ratio"])


def iteration_breakdown(t: TraceTable) -> dict[str, float]:
    """Total seconds by phase (F/B/G) and comm kind — the per-iteration view
    the Chrome-trace timeline shows visually."""
    out = {}
    for ph in ("F", "B", "G"):
        out[f"compute_{ph}"] = float(t.dur[(t.phase == ph) & (t.kind == "compute")].sum())
    out["collective"] = float(t.dur[t.kind == "coll"].sum())
    out["p2p"] = float(t.dur[t.kind == "p2p"].sum())
    return out
