"""Per-rank event synthesis (and induced stragglers), counterpart of
``repro.obs.inject``.

On a cluster every rank runs its own MegaScan tracer, so the online
detector sees per-rank timings.  A run in one process, or a world whose
events come from rank 0's tracer, has one wall clock, so, as
``core.dpp.executor.emit_pipeline_events`` does for the pipeline's bubble
structure, this module scales a model of the step into the measured wall:
per data-parallel rank, a fwd + bwd compute pair followed by the gradient
all-reduce that closes the step.

The straggler part is real, not simulated: with ``slow_rank >= 0`` the
train loop sleeps inside the step scope (simkit's ``compute_slowdown``
fault, applied to the live run), and the measured excess is attributed to
the slow rank's compute here — its all-reduce then starts late by exactly
that excess, which is the signature MegaScan's stage 1 + stage 2 confirm
on.  End to end, a slowed rank produces an ``OnlineDetector`` diagnosis
naming it while the run is still going.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.simkit.workload import Topology
from repro_torch.core.tracing.events import TraceEvent

# healthy step budget: fwd 30%, bwd 50%, gradient all-reduce the last 20%
_FWD_FRAC, _BWD_FRAC = 0.3, 0.5
# nominal P2P ring payload per step (only the bytes/duration ratio feeds
# stage 3's effective-bandwidth comparison)
_P2P_BYTES = 1 << 20


@dataclass(frozen=True)
class RankEventSpec:
    """Topology + straggler model for synthesized per-rank events.

    ``slow_rank`` / ``slow_factor`` mirror simkit's ``FaultModel.
    compute_slowdown`` semantics: the rank runs at ``slow_factor`` of full
    speed (0.5 = half), ``slow_rank < 0`` disables induction.
    """

    dp: int = 2
    pp: int = 1
    tp: int = 1
    slow_rank: int = -1
    slow_factor: float = 0.5
    # degraded directed link (FaultModel.link_slowdown semantics): when set,
    # a ring of P2P sends is synthesized each step with this edge running at
    # ``degrade_factor`` of the healthy bandwidth — stage 3's signature
    degrade_link: tuple[int, int] | None = None
    degrade_factor: float = 0.25

    @property
    def world(self) -> int:
        return self.dp * self.pp * self.tp

    def topology(self) -> Topology:
        return Topology(dp=self.dp, pp=self.pp, tp=self.tp)

    def extra_seconds(self, base: float) -> float:
        """Sleep that stretches a ``base``-seconds step to ``base /
        slow_factor`` — the live analogue of a downclocked rank."""
        if self.slow_rank < 0 or not 0.0 < self.slow_factor < 1.0:
            return 0.0
        return base * (1.0 / self.slow_factor - 1.0)


def emit_rank_events(
    events: list[TraceEvent],
    spec: RankEventSpec,
    *,
    ts: float,
    wall: float,
    extra: float = 0.0,
    step: int = 0,
) -> None:
    """Append one step's per-rank fwd/bwd/all-reduce events into ``events``.

    ``[ts, ts + wall]`` is the measured step window; ``extra`` of it was
    induced straggler sleep.  Healthy ranks split ``wall - extra`` into the
    canonical fwd/bwd/all-reduce budget; the slow rank's compute stretches
    by ``extra`` (split pro rata over fwd/bwd) and its all-reduce — which
    every rank finishes together, at ``ts + wall`` — therefore starts late.
    """
    base = max(wall - extra, 1e-9)
    group = tuple(range(spec.world))
    fwd, bwd = _FWD_FRAC * base, _BWD_FRAC * base
    compute = fwd + bwd
    for r in range(spec.world):
        e_r = extra if r == spec.slow_rank else 0.0
        f_r = fwd + e_r * (fwd / compute)
        b_r = bwd + e_r * (bwd / compute)
        events.append(TraceEvent(
            "fwd", r, ts, f_r, "compute",
            {"op": "fwd", "mb": step, "phase": "F"},
        ))
        events.append(TraceEvent(
            "bwd", r, ts + f_r, b_r, "compute",
            {"op": "bwd", "mb": step, "phase": "B"},
        ))
        start = ts + f_r + b_r
        events.append(TraceEvent(
            "allreduce_grads", r, start, max(ts + wall - start, 1e-9), "coll",
            {"op": "allreduce", "group": group, "mb": step, "phase": "G"},
        ))
    if spec.degrade_link is not None and spec.world >= 2:
        # a ring of activation-sized P2P sends, concurrent with compute:
        # healthy edges move _P2P_BYTES in 10% of the step, the degraded
        # edge takes 1/degrade_factor as long for the same payload — the
        # effective-bandwidth dip stage 3 flags against the ring median
        healthy_dur = 0.1 * base
        for r in range(spec.world):
            dst = (r + 1) % spec.world
            slow = 1.0 / spec.degrade_factor if (r, dst) == spec.degrade_link else 1.0
            events.append(TraceEvent(
                "p2p_send", r, ts, healthy_dur * slow, "p2p",
                {"dir": "send", "peer": dst, "bytes": _P2P_BYTES, "mb": step},
            ))
