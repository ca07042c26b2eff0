"""Runtime tracer (MegaScan's ``tracers.scope``), background JSONL
persistence and trace loaders: a copy of ``repro.core.tracing.tracer``.

The host monotonic clock brackets each scope.  PyTorch returns before the
card finishes, so a caller that wants a scope to cover device work ends it
with a value read back to the host (the serving ticks read their sampled
tokens and the train loop its loss inside the scope).  Persistence runs on
a background thread so tracing never stalls the training loop (§3.2 "Log
pre-processing").
"""

from __future__ import annotations

import json
import queue
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Iterable

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

    def record(self, name: str, ts: float, dur: float, kind: str = "compute",
               **args: Any) -> None:
        if self.enabled:
            self.events.append(TraceEvent(name, self.rank, ts, dur, kind, dict(args)))

    def instant(self, name: str, **args: Any) -> None:
        self.record(name, self.clock(), 0.0, "marker", **args)

    def clear(self) -> None:
        self.events = []


def gather_traces(tracers: Iterable[Tracer]) -> list[TraceEvent]:
    """Rank-0 gather: merge per-rank buffers, time-ordered."""
    out: list[TraceEvent] = []
    for t in tracers:
        out.extend(t.events)
    out.sort(key=lambda e: (e.ts, e.rank))
    return out


class AsyncTraceWriter:
    """Background JSONL persistence (keeps the training path stall-free).

    Streaming semantics: rows are flushed every ``flush_every`` writes and
    whenever the queue goes idle for ``idle_s``, so a mid-run crash leaves
    every completed step's events readable on disk (``load_jsonl``) instead
    of losing the whole end-of-run export.  ``mode="w"`` truncates at open —
    the per-run streaming default; ``"a"`` appends across runs.
    """

    def __init__(
        self,
        path: str | Path,
        *,
        mode: str = "a",
        flush_every: int = 64,
        idle_s: float = 0.2,
    ):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._mode = mode
        self._flush_every = max(flush_every, 1)
        self._idle_s = idle_s
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        with open(self.path, self._mode) as f:
            pending = 0
            while True:
                try:
                    item = self._q.get(timeout=self._idle_s)
                except queue.Empty:
                    if pending:
                        f.flush()
                        pending = 0
                    continue
                if item is None:
                    f.flush()
                    break
                f.write(json.dumps(item.to_json()) + "\n")
                pending += 1
                if pending >= self._flush_every:
                    f.flush()
                    pending = 0

    def submit(self, events: Iterable[TraceEvent]) -> None:
        for e in events:
            self._q.put(e)

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()


def load_jsonl(path: str | Path) -> list[TraceEvent]:
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(TraceEvent.from_json(json.loads(line)))
    return out


def load_trace(path: str | Path) -> list[TraceEvent]:
    """Load a saved trace whatever its format: a chrome-trace JSON document
    (object with ``traceEvents``, or a bare event array) or the streamed
    JSONL that ``AsyncTraceWriter`` produces.  A whole-file parse
    discriminates the formats (JSONL rows are also objects, so sniffing the
    first character would misfire), so ``trace --detect`` accepts either
    the ``--trace-out`` export or its ``.jsonl`` streaming sidecar."""
    text = Path(path).read_text()
    try:
        # a chrome trace is ONE JSON value spanning the file (a JSONL file
        # with 2+ rows fails here: trailing data after the first object)
        doc = json.loads(text)
    except json.JSONDecodeError:
        return [
            TraceEvent.from_json(json.loads(line))
            for line in text.splitlines() if line.strip()
        ]
    if isinstance(doc, list):
        doc = {"traceEvents": doc}
    if "traceEvents" in doc:
        from repro_torch.core.tracing.chrome import from_chrome

        return from_chrome(doc)
    return [TraceEvent.from_json(doc)]  # single-row JSONL
