"""Declarative chaos injection for fault-tolerance runs, counterpart of
``repro.ft.chaos``.

A :class:`ChaosSpec` names the anomalies a run should survive — a process
crash at a step, a NaN batch, a rank downclocked from some step on, a
degraded DP link — in one declarative object that works at both fidelity
levels:

* **simkit** (offline): :meth:`ChaosSpec.to_fault_model` turns the spec into
  an engine :class:`~repro_torch.core.simkit.engine.FaultModel`, and
  :func:`simulate_policy` runs the simulate -> align -> detect ->
  :class:`~repro_torch.ft.mitigation.MitigationPolicy` pipeline without
  touching a device;
* **live**: a :class:`ChaosInjector` is consumed by the real train loop
  (``--set ft.chaos.crash_at_step=5``): the crash raises a real
  :class:`InjectedCrash` at the step's top, the NaN corrupts the numpy
  batch's ``loss_mask`` before it goes to the device, so the loss goes NaN
  through the actual forward, and the straggler/link faults drive
  ``repro_torch.obs.inject`` event synthesis plus real in-step sleeps.

Crash and NaN injections fire once: after the loop restores and replays the
step, the injector remembers it already fired, as a real transient fault
would, which is what makes the recovered run's final loss comparable to a
fault-free run (step-indexed batches).  In a world of ranks every rank holds
the same spec, so they fire on every rank at the same step.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.simkit.engine import FaultModel


class InjectedCrash(RuntimeError):
    """A chaos-injected process failure (raised at the step's top)."""


def parse_link(spec: str) -> tuple[int, int]:
    """Parse a directed link spec ``"src-dst"`` -> ``(src, dst)``."""
    try:
        src, _, dst = spec.partition("-")
        return int(src), int(dst)
    except ValueError as e:
        raise ValueError(
            f"degrade_link wants 'src-dst' (e.g. '0-1'), got {spec!r}"
        ) from e


@dataclass(frozen=True)
class ChaosSpec:
    """What goes wrong, declaratively.  All fields default to "nothing"."""

    crash_at_step: int = -1        # raise InjectedCrash at this step (< 0 off)
    nan_at_step: int = -1          # poison this step's batch to a NaN loss
    slow_rank_from: int = -1       # downclock ``slow_rank`` from this step on
    slow_rank: int = 1
    slow_factor: float = 0.5       # its relative speed (0.5 = half)
    degrade_link: str = ""         # directed "src-dst" DP link ("" = healthy)
    degrade_factor: float = 0.25   # its relative bandwidth

    @property
    def active(self) -> bool:
        return (
            self.crash_at_step >= 0 or self.nan_at_step >= 0
            or self.slow_rank_from >= 0 or bool(self.degrade_link)
        )

    @property
    def needs_restore(self) -> bool:
        """True when this chaos can only be survived via checkpoint restore."""
        return self.crash_at_step >= 0

    def to_fault_model(self, *, jitter: float = 0.01, seed: int = 0) -> FaultModel:
        """The simkit view of this spec (crash/NaN have no offline analogue —
        they are recovery faults, not timeline faults)."""
        compute = (
            {self.slow_rank: self.slow_factor} if self.slow_rank_from >= 0 else {}
        )
        links = (
            {parse_link(self.degrade_link): self.degrade_factor}
            if self.degrade_link else {}
        )
        return FaultModel(
            compute_slowdown=compute, link_slowdown=links,
            jitter=jitter, seed=seed,
        )


@dataclass
class ChaosInjector:
    """Stateful live-run driver for a :class:`ChaosSpec`.

    One-shot faults (crash, NaN) track whether they already fired so a
    restore-and-replay of the same step does not re-fire them.
    """

    spec: ChaosSpec
    fired: set[str] = field(default_factory=set)

    def crash_due(self, step: int) -> bool:
        if self.spec.crash_at_step == step and "crash" not in self.fired:
            self.fired.add("crash")
            return True
        return False

    def poison_batch(self, batch: dict, step: int) -> dict:
        """NaN the numpy loss mask once at ``nan_at_step``: the loss goes
        NaN through the real masked-CE forward, grads follow, and without a
        guard the optimizer state is corrupted — the failure mode the
        in-band guards exist to catch."""
        if self.spec.nan_at_step != step or "nan" in self.fired:
            return batch
        self.fired.add("nan")
        poisoned = dict(batch)
        mask = np.asarray(batch["loss_mask"], dtype=np.float32)
        poisoned["loss_mask"] = np.full_like(mask, np.nan)
        return poisoned

    def slow_active(self, step: int) -> bool:
        return 0 <= self.spec.slow_rank_from <= step

    def link(self) -> tuple[int, int] | None:
        return parse_link(self.spec.degrade_link) if self.spec.degrade_link else None


def simulate_policy(
    spec: ChaosSpec,
    topo=None,
    *,
    n_micro: int = 8,
    n_iters: int = 10,  # 1 gradient sync per iter: >= MitigationPolicy.min_evidence
    policy=None,
    seed: int = 0,
    thresholds: dict | None = None,
):
    """Offline what-if: simulate a trace under ``spec``, run the 3-stage
    detector, and ask the :class:`MitigationPolicy` what it would do.

    Returns ``(diagnosis, action, info)`` — the same triple the live
    ``FtController`` acts on, at simkit speed.  The default topology is
    ``dp=2, pp=2, tp=1`` (the smallest shape with both DP peers and a
    pipeline to degrade links on).
    """
    from repro_torch.core.simkit.workload import ModelProfile, Topology
    from repro_torch.core.tracing import (
        ClockModel,
        align_clocks,
        apply_alignment,
        detect,
        simulate_trace,
    )
    from repro_torch.ft.mitigation import MitigationPolicy

    topo = topo or Topology(dp=2, pp=2, tp=1)
    events, _truth = simulate_trace(
        topo, ModelProfile(), n_micro=n_micro, n_iters=n_iters,
        faults=spec.to_fault_model(seed=seed), clocks=ClockModel(seed=seed),
    )
    aligned = apply_alignment(events, align_clocks(events))
    diag = detect(aligned, topo, **(thresholds or {}))
    action, info = (policy or MitigationPolicy()).decide(diag)
    return diag, action, info
