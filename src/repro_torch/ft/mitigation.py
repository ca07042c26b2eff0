"""Straggler mitigation policy, a copy of ``repro.ft.mitigation``: a
MegaScan diagnosis -> an action.

Closes the loop the paper leaves as future work ("native support for fast
failover after anomaly detection"): detection output drives either a MegaDPP
re-plan (soft mitigation — shift work away from a slow stage / degraded link)
or exclusion + elastic restart (hard mitigation) depending on severity.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from repro_torch.core.tracing.detect import Diagnosis


class MitigationAction(Enum):
    NONE = "none"
    REPLAN = "replan"            # MegaDPP schedule re-plan around the anomaly
    EXCLUDE_RESTART = "exclude"  # drop the node, elastic restart from ckpt


@dataclass
class MitigationPolicy:
    slow_frac_soft: float = 0.3    # slow-op fraction -> replan
    slow_frac_hard: float = 0.7    # -> exclude + restart
    min_evidence: int = 8          # collective instances before acting

    def decide(self, diag: Diagnosis) -> tuple[MitigationAction, dict]:
        if diag.evidence.get("n_instances", 0) < self.min_evidence:
            return MitigationAction.NONE, {"reason": "insufficient evidence"}
        if not diag.slow_ranks and not diag.degraded_links:
            return MitigationAction.NONE, {"reason": "healthy"}
        worst = 0.0
        for r in diag.slow_ranks:
            worst = max(worst, diag.rank_scores.get(r, {}).get("slow_op_frac", 0.0))
        if worst >= self.slow_frac_hard:
            return MitigationAction.EXCLUDE_RESTART, {
                "exclude_ranks": diag.slow_ranks, "severity": worst,
            }
        return MitigationAction.REPLAN, {
            "slow_ranks": diag.slow_ranks,
            "degraded_links": diag.degraded_links,
            "severity": worst,
        }
