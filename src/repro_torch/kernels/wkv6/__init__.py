from repro_torch.kernels.wkv6.ops import (
    WKV6,
    launches,
    reset_launches,
    wkv6,
    wkv6_bwd_kernel,
    wkv6_fwd_kernel,
)
from repro_torch.kernels.wkv6.ref import wkv6_bwd_plain, wkv6_plain

__all__ = [
    "WKV6",
    "launches",
    "reset_launches",
    "wkv6",
    "wkv6_bwd_kernel",
    "wkv6_bwd_plain",
    "wkv6_fwd_kernel",
    "wkv6_plain",
]
