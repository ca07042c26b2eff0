"""MegaFBD on the port: the bit-vector coordinator, virtual/physical rank
placement and the decoupled forward/backward, counterpart of
``repro.core.fbd``."""

from repro_torch.core.fbd.coordinator import (
    BitVectorCoordinator,
    CollectiveRequest,
    ThreadProgram,
    run_fcfs,
    run_with_coordinator,
)
from repro_torch.core.fbd.decouple import (
    DecoupledStep,
    Residuals,
    decoupled_grad,
    make_decoupled_step,
)
from repro_torch.core.fbd.ranks import (
    FBDPlacement,
    VirtualPhysicalMap,
    colocated_placement,
    evaluate_placement,
    plan_placement,
)

__all__ = [
    "BitVectorCoordinator",
    "CollectiveRequest",
    "ThreadProgram",
    "run_with_coordinator",
    "run_fcfs",
    "VirtualPhysicalMap",
    "FBDPlacement",
    "plan_placement",
    "colocated_placement",
    "evaluate_placement",
    "DecoupledStep",
    "Residuals",
    "make_decoupled_step",
    "decoupled_grad",
]
