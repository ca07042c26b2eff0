from repro_torch.kernels.rmsnorm.ops import (
    launches,
    reset_launches,
    rmsnorm,
    rmsnorm_bwd_kernel,
    rmsnorm_fwd_kernel,
)
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_plain, rmsnorm_plain

__all__ = [
    "launches",
    "reset_launches",
    "rmsnorm",
    "rmsnorm_bwd_kernel",
    "rmsnorm_bwd_plain",
    "rmsnorm_fwd_kernel",
    "rmsnorm_plain",
]
