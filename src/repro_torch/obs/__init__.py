"""Live telemetry, counterpart of ``repro.obs``: the metrics registry
(counters, gauges, histograms with streaming P50/P95/P99) and its exporters
(JSONL time series, Prometheus text, chrome counter events merged into the
shared ``--trace-out``).  The ``metrics`` module plugin owns a registry;
the train loop and MegaServe publish into it.  :class:`OnlineDetector`
runs MegaScan's ``detect()`` over a sliding window of recent
``TraceEvent``s while the workload runs (the ``scan`` plugin's
``--detect-online``), and :func:`emit_rank_events` synthesizes per-rank
events (with an induced straggler) from one measured step, so a run whose
events share one clock exercises the detector end to end.
"""

from repro_torch.obs.detector import DetectionUpdate, OnlineDetector
from repro_torch.obs.export import (
    JsonlExporter,
    counter_events,
    flatten_snapshot,
    prometheus_text,
)
from repro_torch.obs.inject import RankEventSpec, emit_rank_events
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry, P2Quantile

__all__ = [
    "Counter",
    "DetectionUpdate",
    "Gauge",
    "Histogram",
    "JsonlExporter",
    "MetricsRegistry",
    "OnlineDetector",
    "P2Quantile",
    "RankEventSpec",
    "counter_events",
    "emit_rank_events",
    "flatten_snapshot",
    "prometheus_text",
]
