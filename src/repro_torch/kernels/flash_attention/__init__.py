from repro_torch.kernels.flash_attention.ops import (
    FlashAttention,
    flash_attention,
    flash_bwd_kernel,
    flash_fwd_kernel,
    launches,
    reset_launches,
)
from repro_torch.kernels.flash_attention.ref import flash_bwd_plain, flash_fwd_plain

__all__ = [
    "FlashAttention",
    "flash_attention",
    "flash_bwd_kernel",
    "flash_bwd_plain",
    "flash_fwd_kernel",
    "flash_fwd_plain",
    "launches",
    "reset_launches",
]
