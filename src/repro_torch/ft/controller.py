"""FtController, counterpart of ``repro.ft.controller``: the decide half of
detect -> decide -> mitigate -> recover, as plain Python.

The :class:`~repro_torch.app.plugins.ScanPlugin`'s online detector emits
:class:`~repro_torch.obs.detector.DetectionUpdate`s; the controller runs
:class:`~repro_torch.ft.mitigation.MitigationPolicy` over each diagnosis and
turns decisions into pending actions the train loop executes at the next
step's top:

* ``REPLAN`` with degraded DP links -> switch on
  :class:`~repro_torch.ft.compress.GradCompressor` int8 gradient sync;
* ``REPLAN`` with slow ranks on a pipeline run -> re-resolve the MegaDPP
  schedule around the slow stage (``Planner.replan``);
* ``EXCLUDE_RESTART`` -> mark the rank excluded and roll back through the
  checkpoint.

Each distinct decision executes once (the detector keeps re-confirming a
standing diagnosis every pass; acting on every pass would restart forever).
The controller also owns the in-band guards (NaN/inf loss, grad-norm spike)
and the :class:`~repro_torch.ft.chaos.ChaosInjector` driving the faults it
is proving recovery from, plus the mitigation timeline that lands in
``results["ft"]``.
"""

from __future__ import annotations

import logging
import math
from collections import deque
from dataclasses import dataclass, replace

from repro_torch.ft.chaos import ChaosInjector
from repro_torch.ft.mitigation import MitigationAction, MitigationPolicy

log = logging.getLogger("repro_torch.ft")


@dataclass
class FtOptions:
    """Supervision + guard knobs (mirrors ``RunConfig.ft``)."""

    max_restarts: int = 3
    backoff_s: float = 0.0         # base restart backoff (doubles per restart)
    guard_nan: bool = True         # nonfinite loss -> guard_action
    guard_spike: float = 0.0       # >0: grad_norm > spike * running median
    guard_action: str = "rollback"  # rollback | skip


@dataclass(frozen=True)
class PendingAction:
    """One decided-but-not-yet-executed mitigation."""

    kind: str                      # "replan" | "exclude"
    detect_step: int               # detector pass (push count) that decided it
    slow_ranks: tuple[int, ...] = ()
    degraded_links: tuple[tuple[int, int], ...] = ()
    severity: float = 0.0


class FtController:
    """Session-lifetime fault-tolerance state machine.

    Built by the ``ft`` plugin, registered as a detection listener, and
    threaded into ``train.loop.train``, which polls it every step.
    """

    def __init__(
        self,
        policy: MitigationPolicy | None = None,
        chaos: ChaosInjector | None = None,
        options: FtOptions | None = None,
    ):
        self.policy = policy or MitigationPolicy()
        self.chaos = chaos
        self.options = options or FtOptions()
        self.registry = None           # set by the loop (MetricsRegistry)
        self.timeline: list[dict] = []
        self.restarts = 0
        self.rollbacks = 0
        self.replans = 0
        self.guard_trips = 0
        self.detections = 0
        self.excluded: set[int] = set()
        self.compression_on = False
        self._pending: list[PendingAction] = []
        self._acted: set[tuple] = set()
        self._gnorms: deque[float] = deque(maxlen=64)

    # ------------------------------------------------------------ detection
    def on_detection(self, update) -> None:
        """Policy pass over one online diagnosis (a detection listener)."""
        self.detections += 1
        action, info = self.policy.decide(update.diagnosis)
        if action is MitigationAction.NONE:
            return
        # already-excluded ranks keep haunting the sliding window until
        # their old events roll out — don't re-mitigate them
        ranks = tuple(sorted(set(update.diagnosis.slow_ranks) - self.excluded))
        links = tuple(sorted(tuple(l) for l in update.diagnosis.degraded_links))
        if not ranks and not links:
            return
        sig = (action.value, ranks, links)
        if sig in self._acted:
            return
        self._acted.add(sig)
        kind = "exclude" if action is MitigationAction.EXCLUDE_RESTART else "replan"
        self._pending.append(PendingAction(
            kind=kind, detect_step=update.step, slow_ranks=ranks,
            degraded_links=links, severity=float(info.get("severity", 0.0)),
        ))
        self.record(update.step, f"decide:{action.value}", {
            "slow_ranks": list(ranks),
            "degraded_links": [list(l) for l in links],
            "severity": round(float(info.get("severity", 0.0)), 4),
        })
        log.warning("ft: decision %s (slow=%s links=%s)",
                    action.value, list(ranks), [list(l) for l in links])

    def poll(self) -> list[PendingAction]:
        """Drain pending actions (the loop executes them at the step top)."""
        pending, self._pending = self._pending, []
        return pending

    # ---------------------------------------------------------------- chaos
    def crash_due(self, step: int) -> bool:
        return self.chaos is not None and self.chaos.crash_due(step)

    def poison_batch(self, batch: dict, step: int) -> dict:
        return batch if self.chaos is None else self.chaos.poison_batch(batch, step)

    def effective_obs(self, obs, step: int):
        """Fold chaos faults and exclusions into the per-rank event spec.

        The induced slowdown stops once its rank is excluded — the detector
        then watches the straggler clear, which is the observable proof
        that exclusion worked.
        """
        if obs is None:
            return None
        spec = obs
        if self.chaos is not None:
            c = self.chaos.spec
            if self.chaos.slow_active(step) and c.slow_rank not in self.excluded:
                spec = replace(spec, slow_rank=c.slow_rank,
                               slow_factor=c.slow_factor)
            link = self.chaos.link()
            if link is not None:
                spec = replace(spec, degrade_link=link,
                               degrade_factor=c.degrade_factor)
        if spec.slow_rank >= 0 and spec.slow_rank in self.excluded:
            spec = replace(spec, slow_rank=-1)
        return spec

    # --------------------------------------------------------------- guards
    def check_guards(self, step: int, loss: float, grad_norm: float) -> str | None:
        """In-band step guards; returns the guard action when one trips.

        NaN/inf loss means the update that just ran poisoned the state —
        ``rollback`` restores the last checkpoint (exact-trajectory replay),
        ``skip`` discards the update and keeps going (cheaper, but the
        skipped batch diverges the run from a fault-free trajectory).
        """
        o = self.options
        if o.guard_nan and not (math.isfinite(loss) and math.isfinite(grad_norm)):
            self.guard_trips += 1
            self._count("ft.guard_trips")
            self.record(step, f"guard:{o.guard_action}",
                        {"loss": str(loss), "grad_norm": str(grad_norm)})
            log.warning("ft: nonfinite guard tripped at step %d (loss=%s)",
                        step, loss)
            return o.guard_action
        if o.guard_spike > 0 and len(self._gnorms) >= 8:
            med = sorted(self._gnorms)[len(self._gnorms) // 2]
            if med > 0 and grad_norm > o.guard_spike * med:
                self.guard_trips += 1
                self._count("ft.guard_trips")
                self.record(step, f"guard:{o.guard_action}", {
                    "grad_norm": round(grad_norm, 4),
                    "median": round(med, 4),
                })
                log.warning("ft: grad-spike guard tripped at step %d "
                            "(%.3g > %.1fx median %.3g)",
                            step, grad_norm, o.guard_spike, med)
                return o.guard_action
        if math.isfinite(grad_norm):
            self._gnorms.append(grad_norm)
        return None

    # ----------------------------------------------------------- accounting
    def record(self, step: int, event: str, details: dict | None = None) -> None:
        self.timeline.append({"step": step, "event": event,
                              **({"details": details} if details else {})})

    def record_restart(self, failed_step: int, resumed_step: int, reason: str) -> None:
        self.restarts += 1
        self._count("ft.restarts")
        self.record(failed_step, "restart",
                    {"resumed_step": resumed_step, "reason": reason,
                     "restart": self.restarts})

    def record_rollback(self, step: int, to_step: int) -> None:
        self.rollbacks += 1
        self._count("ft.rollbacks")
        self.record(step, "rollback", {"to_step": to_step})

    def _count(self, name: str, v: float = 1) -> None:
        if self.registry is not None:
            self.registry.counter(name).inc(v)

    def report(self) -> dict:
        """The ``results["ft"]`` payload: mitigation timeline + counters."""
        return {
            "timeline": list(self.timeline),
            "restarts": self.restarts,
            "rollbacks": self.rollbacks,
            "replans": self.replans,
            "guard_trips": self.guard_trips,
            "detections": self.detections,
            "excluded_ranks": sorted(self.excluded),
            "compression_on": self.compression_on,
        }
