from repro_torch.serve.request import Request, RequestStatus
from repro_torch.serve.scheduler import Scheduler, ServeConfig
from repro_torch.serve.server import MegaServe, make_poisson_workload

__all__ = [
    "MegaServe",
    "Request",
    "RequestStatus",
    "Scheduler",
    "ServeConfig",
    "make_poisson_workload",
]
