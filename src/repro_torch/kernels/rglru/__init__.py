from repro_torch.kernels.rglru.ops import (
    RGLRUScan,
    launches,
    reset_launches,
    rglru_bwd_kernel,
    rglru_fwd_kernel,
    rglru_scan,
)
from repro_torch.kernels.rglru.ref import rglru_bwd_plain, rglru_plain

__all__ = [
    "RGLRUScan",
    "launches",
    "reset_launches",
    "rglru_bwd_kernel",
    "rglru_bwd_plain",
    "rglru_fwd_kernel",
    "rglru_plain",
    "rglru_scan",
]
