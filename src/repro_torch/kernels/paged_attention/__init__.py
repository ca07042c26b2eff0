from repro_torch.kernels.paged_attention.ops import (
    PagedInfo,
    launches,
    paged_attention,
    paged_decode_kernel,
    paged_prefill,
    paged_prefill_kernel,
    reset_launches,
    write_kv,
)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_plain,
    paged_prefill_plain,
    paged_prefill_plain_from_raw,
)

__all__ = [
    "PagedInfo",
    "launches",
    "paged_attention",
    "paged_attention_plain",
    "paged_decode_kernel",
    "paged_prefill",
    "paged_prefill_kernel",
    "paged_prefill_plain",
    "paged_prefill_plain_from_raw",
    "reset_launches",
    "write_kv",
]
