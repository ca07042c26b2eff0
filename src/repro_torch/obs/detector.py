"""OnlineDetector, counterpart of ``repro.obs.detector``: MegaScan's
3-stage diagnosis over a sliding window.

The offline pipeline (``trace`` workload) is gather -> align -> detect,
after the run.  The online detector runs the same analysis incrementally:
each workload step pushes its freshly emitted ``TraceEvent``s; every
``every``-th push the window is re-aligned (``align_clocks``), collectives
are re-matched (``reconstruct_collectives`` runs inside ``detect``), and the
3-stage detector produces a :class:`~repro_torch.core.tracing.detect.Diagnosis`.
Only the delta against the previous verdict is returned — a rank turning
slow, a link degrading, a recovery — which is what a failover controller
(or a human watching the trace's instant events) acts on.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from repro_torch.core.simkit.workload import Topology
from repro_torch.core.tracing.align import align_clocks, apply_alignment
from repro_torch.core.tracing.detect import Diagnosis, detect
from repro_torch.core.tracing.events import TraceEvent

_ANALYZED_KINDS = ("compute", "coll", "p2p")


@dataclass
class DetectionUpdate:
    """One online verdict: the full diagnosis plus what changed since the
    previous one (the actionable part)."""

    step: int
    diagnosis: Diagnosis
    new_slow_ranks: list[int] = field(default_factory=list)
    cleared_slow_ranks: list[int] = field(default_factory=list)
    new_degraded_links: list[tuple[int, int]] = field(default_factory=list)

    @property
    def changed(self) -> bool:
        return bool(
            self.new_slow_ranks or self.cleared_slow_ranks
            or self.new_degraded_links
        )


class OnlineDetector:
    """Sliding-window streaming wrapper around MegaScan's ``detect()``.

    ``push(events)`` is called once per workload step with that step's
    events; a detection pass runs every ``every`` pushes over the last
    ``window`` steps.  ``thresholds`` feeds through to ``detect()``
    (``slow_ratio`` / ``candidate_frac`` / ``skew_margin`` / ``late_frac``
    / ``degrade_ratio``).  ``align=True`` (default) re-aligns the window's
    clocks before detecting — a no-op for single-clock hosts, required for
    real per-rank clocks.
    """

    def __init__(
        self,
        topo: Topology,
        *,
        every: int = 8,
        window: int = 64,
        min_events: int = 16,
        align: bool = True,
        thresholds: dict | None = None,
    ):
        if every < 1 or window < 1:
            raise ValueError(f"every/window must be >= 1, got {every}/{window}")
        self.topo = topo
        self.every = every
        self.min_events = min_events
        self.align = align
        self.thresholds = dict(thresholds or {})
        self._window: deque[list[TraceEvent]] = deque(maxlen=window)
        self._step = 0
        self._slow: set[int] = set()
        self._links: set[tuple[int, int]] = set()
        #: one ``Diagnosis.summary()`` (+ step) per completed detection pass
        self.history: list[dict] = []

    def push(self, events: list[TraceEvent]) -> DetectionUpdate | None:
        """Feed one step's events; returns an update when a pass ran."""
        self._step += 1
        self._window.append(
            [e for e in events if e.kind in _ANALYZED_KINDS]
        )
        if self._step % self.every:
            return None
        flat = [e for step_events in self._window for e in step_events]
        if len(flat) < self.min_events:
            return None
        if self.align:
            flat = apply_alignment(flat, align_clocks(flat))
        diag = detect(flat, self.topo, **self.thresholds)
        slow = set(diag.slow_ranks)
        links = {tuple(l) for l in diag.degraded_links}
        update = DetectionUpdate(
            step=self._step,
            diagnosis=diag,
            new_slow_ranks=sorted(slow - self._slow),
            cleared_slow_ranks=sorted(self._slow - slow),
            new_degraded_links=sorted(links - self._links),
        )
        self._slow, self._links = slow, links
        self.history.append({"step": self._step, **diag.summary()})
        return update
