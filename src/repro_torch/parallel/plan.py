"""ParallelPlan: the dp/tp/pp + schedule description threaded through the
app, copied from ``repro.parallel.plan``.

One frozen dataclass describes how a training run parallelizes:

* ``dp`` / ``tp`` — the data / tensor degrees: ``Session`` runs a plan in
  a world of ``world = pp * dp * tp`` ranks on a (stage, data, model)
  ``DeviceMesh`` (``launch.mesh.make_pipeline_mesh``), the batch split over
  ``data`` and Megatron's tensor split of dense GQA blocks over ``model``
  (``train.train_step``);
* ``pp`` / ``n_micro`` / ``n_chunks`` / ``schedule`` / ``wave`` — the MegaDPP
  pipeline axis: how many stages, how the (microbatch, chunk) task matrix is
  traversed (``core.dpp.schedule``), and the wave width when the traversal is
  wave-parametrized.  ``wave=0`` with ``schedule="wave"`` delegates the choice
  to MegaDPP's resource-aware planner (best-effort BFC under the memory cap);
* ``fbd_backward`` — attach MegaFBD's decoupled backward: the pipelined
  step's gradients come from ``core.fbd.decouple.make_decoupled_step``'s
  forward instance and backward instance instead of one fused
  ``torch.autograd.grad``.

``repro_torch.app.Session`` builds a plan from the ``parallel`` config
section and hands it to ``train.loop.train`` ->
``train.train_step.make_train_step``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.dpp.schedule import (
    Step,
    sched_1f1b,
    sched_bfc,
    sched_dfc,
    sched_wave,
)

PP_SCHEDULES = ("1f1b", "dfc", "bfc", "wave")


@dataclass(frozen=True)
class ParallelPlan:
    dp: int = 1
    tp: int = 1
    pp: int = 1
    n_micro: int = 0           # 0 = resolve_plan picks (2*pp when pp>1)
    n_chunks: int = 1
    schedule: str = "1f1b"     # one of PP_SCHEDULES
    wave: int = 0              # 0 + schedule="wave" = planner chooses
    fbd_backward: bool = False

    @property
    def world(self) -> int:
        return self.dp * self.tp * self.pp

    @property
    def n_micro_local(self) -> int:
        """Microbatches one dp group pipelines: the ``n_micro`` global
        microbatches shard evenly across the ``data`` axis, and each dp group
        runs its own copy of the schedule over its slice."""
        return self.n_micro // self.dp if self.n_micro else self.n_micro

    def topology(self):
        """The rank <-> (dp, stage, tp) coordinate mapping of the composed
        mesh (``core.simkit.workload.Topology``) — what the ft/obs paths use
        to decide which axis a detected link or straggler lives on."""
        from repro_torch.core.simkit.workload import Topology

        return Topology(dp=self.dp, pp=self.pp, tp=self.tp)

    def validate(self) -> "ParallelPlan":
        if min(self.dp, self.tp, self.pp) < 1:
            raise ValueError(f"parallel degrees must be >= 1, got {self}")
        if self.schedule not in PP_SCHEDULES:
            raise ValueError(
                f"unknown pipeline schedule {self.schedule!r}; "
                f"one of {PP_SCHEDULES}"
            )
        if self.pp > 1 and self.n_micro < 0:
            raise ValueError(f"n_micro must be >= 0, got {self.n_micro}")
        if self.pp > 1 and self.n_micro and self.n_micro % self.dp != 0:
            raise ValueError(
                f"n_micro={self.n_micro} not divisible by dp={self.dp}: "
                "the microbatch axis shards evenly across dp groups"
            )
        return self


def resolve_plan(
    plan: ParallelPlan,
    *,
    memory_cap_gib: float = 8.0,
    prof=None,
) -> ParallelPlan:
    """Fill derived fields: default microbatch count, planner-chosen wave.

    The wave choice *is* MegaDPP's planner (``core.dpp.planner.Planner``):
    candidate waves are simulated on the simkit engine and the fastest one
    fitting the activation-memory cap wins — "adopt BFC as long as it does
    not OOM".
    """
    plan.validate()
    if plan.pp <= 1:
        return plan
    if plan.n_micro == 0:
        # 2 microbatches per stage *per dp group* keeps the per-group
        # pipeline depth (and so the bubble fraction) independent of dp
        plan = replace(plan, n_micro=2 * plan.pp * plan.dp)
    if plan.schedule == "wave" and plan.wave == 0:
        from repro_torch.core.dpp.planner import Planner
        from repro_torch.core.simkit.workload import ModelProfile

        planner = Planner(
            plan.topology(),
            prof or ModelProfile(n_chunks=plan.n_chunks),
            n_micro=plan.n_micro_local,
            memory_cap=int(memory_cap_gib * (1 << 30)),
        )
        plan = replace(plan, wave=planner.plan().wave)
    return plan


def forward_order(plan: ParallelPlan) -> list[Step]:
    """The desired (microbatch, chunk) visit order the executor's time table
    legalizes.  Only the F steps matter to the forward table; the backward
    traversal is autodiff's mirror.  Microbatch indices are *dp-local*: each
    dp group runs the same table over its ``n_micro_local`` slice of the
    globally-sharded microbatch axis."""
    nm, c = plan.n_micro_local, plan.n_chunks
    if plan.schedule == "dfc":
        return sched_dfc(nm, c)
    if plan.schedule == "bfc":
        return sched_bfc(nm, c)
    if plan.schedule == "wave":
        return sched_wave(nm, c, plan.wave or max(1, nm // 2))
    if plan.schedule == "1f1b":
        return sched_1f1b(nm, c, plan.pp, 0)
    raise ValueError(f"unknown pipeline schedule {plan.schedule!r}")


def link_axis(plan: ParallelPlan, link) -> str:
    """Which mesh axis a (rank, rank) link lives on: ``"data"`` / ``"stage"``
    / ``"model"`` for links whose endpoints differ in exactly one coordinate
    of the plan topology, ``"self"`` for a degenerate same-rank link,
    ``"mixed"`` for diagonal pairs, ``"unknown"`` for out-of-range ranks.

    This is how the ft mitigation picks its lever: data-axis links carry the
    gradient sync (compressible), stage-axis links carry pipeline P2P
    activations (replannable), model-axis links carry in-stage tensor
    collectives (neither — only exclusion helps).
    """
    topo = plan.topology()
    a, b = link
    if not (0 <= a < topo.world and 0 <= b < topo.world):
        return "unknown"
    ca, cb = topo.coords(a), topo.coords(b)
    diffs = [
        name for name, x, y in zip(("data", "stage", "model"), ca, cb)
        if x != y
    ]
    if not diffs:
        return "self"
    return diffs[0] if len(diffs) == 1 else "mixed"


def plan_summary(plan: ParallelPlan) -> dict:
    """JSON-able view for ``session.results`` / bench output."""
    return {
        "dp": plan.dp, "tp": plan.tp, "pp": plan.pp,
        "n_micro": plan.n_micro, "n_micro_local": plan.n_micro_local,
        "n_chunks": plan.n_chunks,
        "schedule": plan.schedule, "wave": plan.wave,
        "fbd_backward": plan.fbd_backward, "world": plan.world,
    }
