"""MegaRoute: a router fronting N MegaServe engine replicas.

Counterpart of ``repro.serve.router``.  Placement policies and SLO-aware
admission live in ``repro_torch.core.simkit.workload`` (host code) so the
offline discrete-event evaluation (``router_workload``) and this live
router execute the same decision logic; this package adds the
engine-replica orchestration — stepping, disaggregated prefill→decode KV
migration, and merged metrics.
"""

from repro_torch.serve.router.router import Router, RouterConfig

__all__ = ["Router", "RouterConfig"]
