"""Runtime tracer (MegaScan's ``tracers.scope``), copied from
``repro.core.tracing.tracer``.

The host monotonic clock brackets each scope.  PyTorch returns before the
card finishes, so a caller that wants a scope to cover device work ends it
with a value read back to the host (the serving ticks read their sampled
tokens inside the scope).  Only the in-memory tracer is ported in this
slice; the JSONL writer and trace loaders arrive with the trace workload.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable

from repro_torch.core.tracing.events import TraceEvent


class Tracer:
    def __init__(
        self,
        rank: int,
        enabled: bool = True,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.rank = rank
        self.enabled = enabled
        self.clock = clock
        self.events: list[TraceEvent] = []

    @contextmanager
    def scope(self, name: str, kind: str = "compute", **args: Any):
        if not self.enabled:
            yield self
            return
        t0 = self.clock()
        try:
            yield self
        finally:
            t1 = self.clock()
            self.events.append(
                TraceEvent(name, self.rank, t0, t1 - t0, kind, dict(args))
            )

    def clear(self) -> None:
        self.events = []

