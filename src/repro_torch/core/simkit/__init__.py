from repro_torch.core.simkit.engine import (
    DeadlockError,
    Engine,
    EngineResult,
    FaultModel,
    Task,
    TaskRecord,
)
from repro_torch.core.simkit.workload import (
    ModelProfile,
    Topology,
    build_training_step,
)

__all__ = [
    "DeadlockError",
    "Engine",
    "EngineResult",
    "FaultModel",
    "Task",
    "TaskRecord",
    "ModelProfile",
    "Topology",
    "build_training_step",
]
