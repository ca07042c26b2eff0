"""Trace event model (MegaScan §3.2 "Workload tracing"), copied from
``repro.core.tracing.events`` so the port's serving scopes emit the same
``TraceEvent`` records as the JAX package.

Events carry the metadata the paper attaches via ``tracers.scope``: microbatch
index, communication volume, peer rank / participating-rank list — everything
dependency reconstruction and fault diagnosis need downstream.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TraceEvent:
    name: str
    rank: int
    ts: float          # start, seconds in the *local* (per-rank) clock
    dur: float
    kind: str = "compute"  # compute | coll | p2p | marker
    args: dict = field(default_factory=dict)

    @property
    def end(self) -> float:
        return self.ts + self.dur

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "rank": self.rank,
            "ts": self.ts,
            "dur": self.dur,
            "kind": self.kind,
            "args": {
                k: (list(v) if isinstance(v, tuple) else v)
                for k, v in self.args.items()
            },
        }

    @classmethod
    def from_json(cls, d: dict) -> "TraceEvent":
        args = dict(d.get("args", {}))
        if "group" in args and isinstance(args["group"], list):
            args["group"] = tuple(args["group"])
        return cls(d["name"], d["rank"], d["ts"], d["dur"], d.get("kind", "compute"), args)
