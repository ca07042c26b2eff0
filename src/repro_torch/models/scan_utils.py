"""Token shift for the recurrent families, counterpart of
``repro.models.scan_utils.shift_tokens``.

The JAX function shifts within shard-aligned chunks plus a halo column so
that GSPMD need not gather a sequence sharded for context parallelism; the
values are those of the plain concat below, which is all one card needs.
The WKV recurrences of that module (``wkv6_sequential``, ``wkv6_chunked``
with a carried state) serve the RWKV serving slice and arrive with it; the
state-free training recurrence is the K5 kernel (``kernels/wkv6``).
"""

from __future__ import annotations

import torch


def shift_tokens(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """The x_{t-1} stream: ``[B, S, D] -> [B, S, D]``; position 0 sees
    ``prev`` ``[B, D]`` (or zeros)."""
    first = (prev[:, None].to(x.dtype) if prev is not None
             else torch.zeros_like(x[:, :1]))
    return torch.cat([first, x[:, :-1]], dim=1)
