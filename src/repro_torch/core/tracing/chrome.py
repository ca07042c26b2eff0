"""Chrome Tracing Format export/import (loadable in chrome://tracing and
Perfetto — §3.2, Fig. 1).  Each rank maps to a process; compute and
communication map to separate threads so overlap is visible.

A copy of ``repro.core.tracing.chrome``; the port keeps its own, as it
imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable

from repro_torch.core.tracing.events import TraceEvent

_TID = {"compute": 0, "coll": 1, "p2p": 2, "marker": 3}


def to_chrome(events: Iterable[TraceEvent]) -> dict:
    out = []
    ranks = set()
    for e in events:
        ranks.add(e.rank)
        if e.kind == "counter":
            # metric samples (repro_torch.obs.export.counter_events) render as
            # counter tracks in Perfetto, alongside the span threads
            out.append({
                "name": e.name,
                "ph": "C",
                "pid": e.rank,
                "ts": e.ts * 1e6,
                "cat": e.kind,
                "args": {k: (list(v) if isinstance(v, tuple) else v)
                         for k, v in e.args.items()},
            })
            continue
        out.append({
            "name": e.name,
            "ph": "X" if e.dur > 0 else "i",
            "pid": e.rank,
            "tid": _TID.get(e.kind, 4),
            "ts": e.ts * 1e6,           # Chrome expects microseconds
            "dur": e.dur * 1e6,
            "cat": e.kind,
            "args": {k: (list(v) if isinstance(v, tuple) else v)
                     for k, v in e.args.items()},
        })
    meta = []
    for r in sorted(ranks):
        meta.append({"name": "process_name", "ph": "M", "pid": r,
                     "args": {"name": f"rank {r}"}})
        for kind, tid in _TID.items():
            meta.append({"name": "thread_name", "ph": "M", "pid": r, "tid": tid,
                         "args": {"name": kind}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def save_chrome(events: Iterable[TraceEvent], path: str | Path) -> None:
    Path(path).write_text(json.dumps(to_chrome(events)))


def from_chrome(doc: dict) -> list[TraceEvent]:
    tid_rev = {v: k for k, v in _TID.items()}
    out = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "C":
            out.append(TraceEvent(
                e["name"], e["pid"], e["ts"] / 1e6, 0.0, "counter",
                dict(e.get("args", {})),
            ))
            continue
        if e.get("ph") not in ("X", "i"):
            continue
        args = dict(e.get("args", {}))
        if isinstance(args.get("group"), list):
            args["group"] = tuple(args["group"])
        out.append(TraceEvent(
            e["name"], e["pid"], e["ts"] / 1e6, e.get("dur", 0.0) / 1e6,
            tid_rev.get(e.get("tid", 0), e.get("cat", "compute")), args,
        ))
    return out
