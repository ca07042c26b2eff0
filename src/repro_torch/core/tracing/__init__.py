from repro_torch.core.tracing.events import TraceEvent
from repro_torch.core.tracing.tracer import (
    AsyncTraceWriter,
    Tracer,
    gather_traces,
    load_jsonl,
    load_trace,
)
from repro_torch.core.tracing.chrome import from_chrome, save_chrome, to_chrome
from repro_torch.core.tracing.align import (
    CollectiveInstance,
    align_clocks,
    apply_alignment,
    reconstruct_collectives,
)
from repro_torch.core.tracing.detect import Diagnosis, detect
from repro_torch.core.tracing.simulate import ClockModel, simulate_trace

__all__ = [
    "TraceEvent",
    "Tracer",
    "AsyncTraceWriter",
    "gather_traces",
    "load_jsonl",
    "load_trace",
    "to_chrome",
    "save_chrome",
    "from_chrome",
    "CollectiveInstance",
    "reconstruct_collectives",
    "align_clocks",
    "apply_alignment",
    "Diagnosis",
    "detect",
    "ClockModel",
    "simulate_trace",
]
