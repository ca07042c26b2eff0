from repro_torch.core.dpp.schedule import (
    Step,
    legalize,
    sched_bfc,
    sched_dfc,
    sched_wave,
    sched_zb_split,
    schedule_table,
)
from repro_torch.core.dpp.planner import PlanResult, Planner

__all__ = [
    "Step",
    "sched_dfc",
    "sched_bfc",
    "sched_wave",
    "sched_zb_split",
    "legalize",
    "schedule_table",
    "Planner",
    "PlanResult",
]
