from repro_torch.serve.paged_cache import (
    BlockAllocator,
    PagedKVCache,
    PoolExhausted,
    PoolSpec,
    blocks_for,
)
from repro_torch.serve.request import Request, RequestStatus
from repro_torch.serve.router import Router, RouterConfig
from repro_torch.serve.sampler import greedy_verify, rejection_verify, sample
from repro_torch.serve.scheduler import Scheduler, ServeConfig
from repro_torch.serve.server import (
    MegaServe,
    StaticRunner,
    StreamItem,
    make_poisson_workload,
    run_static,
)
from repro_torch.serve.spec import Drafter, NGramDrafter, RandomDrafter, get_drafter

__all__ = [
    "BlockAllocator",
    "Drafter",
    "MegaServe",
    "NGramDrafter",
    "PagedKVCache",
    "PoolExhausted",
    "PoolSpec",
    "RandomDrafter",
    "Request",
    "RequestStatus",
    "Router",
    "RouterConfig",
    "Scheduler",
    "ServeConfig",
    "StaticRunner",
    "StreamItem",
    "blocks_for",
    "get_drafter",
    "greedy_verify",
    "make_poisson_workload",
    "rejection_verify",
    "run_static",
    "sample",
]
