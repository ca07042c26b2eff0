"""Parallel plans, counterpart of ``repro.parallel``: the plan's names only.
The logical-axis sharding rules of dp/tp (``parallel/sharding.py``,
``parallel/profiles.py``) come with ROADMAP item 8b."""

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
