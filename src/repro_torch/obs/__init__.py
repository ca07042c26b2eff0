"""Live telemetry, counterpart of ``repro.obs``: the metrics registry
(counters, gauges, histograms with streaming P50/P95/P99) and its exporters
(JSONL time series, Prometheus text, chrome counter events merged into the
shared ``--trace-out``).  The ``metrics`` module plugin owns a registry;
the train loop and MegaServe publish into it.

The online straggler detector (``repro.obs.detector``) and per-rank event
synthesis (``repro.obs.inject``) are ported with MegaFT (ROADMAP queue 1,
item 9).
"""

from repro_torch.obs.export import (
    JsonlExporter,
    counter_events,
    flatten_snapshot,
    prometheus_text,
)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry, P2Quantile

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlExporter",
    "MetricsRegistry",
    "P2Quantile",
    "counter_events",
    "flatten_snapshot",
    "prometheus_text",
]
