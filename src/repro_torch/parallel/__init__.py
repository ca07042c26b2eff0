"""Parallel plans, worlds and sharding rules, counterpart of
``repro.parallel``: the ``ParallelPlan`` (dp x tp x pp and the pipeline
schedule, ``plan``), the logical-axis rules (``sharding``, ``profiles``)
and the port's own ``dist`` (joining or spawning a world of ranks, the
backend rule, Megatron's conjugate pair, gradient sums, pipeline
hand-offs)."""

from repro_torch.parallel.plan import (
    PP_SCHEDULES,
    ParallelPlan,
    forward_order,
    plan_summary,
    resolve_plan,
)

__all__ = [
    "PP_SCHEDULES",
    "ParallelPlan",
    "forward_order",
    "plan_summary",
    "resolve_plan",
]
