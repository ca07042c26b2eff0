from repro_torch.core.tracing.events import TraceEvent
from repro_torch.core.tracing.tracer import Tracer

__all__ = ["TraceEvent", "Tracer"]
