"""Exporters: JSONL time series, Prometheus text format, chrome counters.

Three sinks for one :class:`repro_torch.obs.metrics.MetricsRegistry`:

* :class:`JsonlExporter` — one flat JSON object per sample, written and
  flushed per row by a background thread (the step's thread only queues
  it), so a mid-run crash still leaves every completed row on disk;
* :func:`prometheus_text` — the text exposition format (``# TYPE`` lines,
  ``quantile`` labels, ``_count``/``_sum`` for histograms) ready to drop
  behind any scrape endpoint or push gateway;
* :func:`counter_events` — chrome ``ph: "C"`` counter ``TraceEvent``s that
  merge into the shared ``--trace-out`` export, rendering metric tracks in
  Perfetto alongside the MegaScan spans.

A copy of ``repro.obs.export``; the port keeps its own, as it imports
nothing of the JAX package.  Its ``JsonlExporter`` writes on a thread of its
own where the JAX package's writes in line: the rows are the same.
"""

from __future__ import annotations

import json
import queue
import re
import threading
from pathlib import Path

from repro_torch.core.tracing.events import TraceEvent
from repro_torch.obs.metrics import MetricsRegistry

_PROM_SAFE = re.compile(r"[^a-zA-Z0-9_]")
_PROM_Q = {"p50": "0.5", "p95": "0.95", "p99": "0.99"}


def flatten_snapshot(snapshot: dict) -> dict[str, float]:
    """Flatten a registry snapshot to scalar series: histogram stats expand
    to ``name.p50`` / ``name.count`` / ... leaves."""
    flat: dict[str, float] = {}
    for name, v in snapshot.items():
        if isinstance(v, dict):
            for stat, sv in v.items():
                flat[f"{name}.{stat}"] = sv
        else:
            flat[name] = v
    return flat


class JsonlExporter:
    """Append-per-sample JSONL time series (crash-usable: flushed per row).

    ``write`` queues the row for a background thread, which serialises and
    flushes it; a row must not be changed after it is written.  ``close``
    waits until every queued row is on disk."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "w")
        self.rows = 0
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while (row := self._q.get()) is not None:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()
        self._f.close()

    def write(self, row: dict) -> None:
        self._q.put(row)
        self.rows += 1

    def close(self) -> None:
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()


def prometheus_text(registry: MetricsRegistry, prefix: str = "repro_") -> str:
    """Render a registry in the Prometheus text exposition format."""
    lines: list[str] = []
    for name, value in registry.snapshot().items():
        pn = prefix + _PROM_SAFE.sub("_", name)
        if isinstance(value, dict):  # histogram -> summary with quantiles
            lines.append(f"# TYPE {pn} summary")
            for label, q in _PROM_Q.items():
                if label in value:
                    lines.append(f'{pn}{{quantile="{q}"}} {value[label]}')
            lines.append(f"{pn}_count {value.get('count', 0)}")
            lines.append(f"{pn}_sum {value.get('sum', 0.0)}")
        else:
            kind = registry.kind_of(name)
            lines.append(f"# TYPE {pn} {'counter' if kind == 'counter' else 'gauge'}")
            lines.append(f"{pn} {value}")
    return "\n".join(lines) + "\n"


def counter_events(
    snapshot: dict, *, ts: float, rank: int = 0
) -> list[TraceEvent]:
    """One chrome counter ``TraceEvent`` per scalar series at time ``ts``.

    Accepts either a raw registry snapshot or an already-flat dict; all
    series flatten to ``kind="counter"`` events whose single ``value`` arg
    becomes the counter track's sample (``chrome.to_chrome`` maps the kind
    to ``ph: "C"``).  Histogram bookkeeping leaves (count/sum/min/max) are
    skipped — quantiles and means are the tracks worth plotting.
    """
    out = []
    for name, v in flatten_snapshot(snapshot).items():
        stat = name.rsplit(".", 1)[-1]
        if stat in ("count", "sum", "min", "max"):
            continue
        out.append(TraceEvent(name, rank, ts, 0.0, "counter", {"value": v}))
    return out


__all__ = [
    "JsonlExporter",
    "counter_events",
    "flatten_snapshot",
    "prometheus_text",
]
