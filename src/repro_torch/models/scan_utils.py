"""Token shift and the causal depthwise convolution of the recurrent
families, counterparts of ``repro.models.scan_utils.shift_tokens`` and
``causal_conv1d``.

The JAX functions shift within shard-aligned chunks plus a halo column so
that GSPMD need not gather a sequence sharded for context parallelism; the
values are those of the plain concat below, which is all one card needs.
The recurrences of that module with a carried state (``wkv6_sequential``,
``wkv6_chunked`` and ``lru_scan`` with a state) serve the RWKV and Griffin
serving slices and arrive with them; the state-free training recurrences are
the K5 and K6 kernels (``kernels/wkv6``, ``kernels/rglru``).
"""

from __future__ import annotations

import torch


def shift_tokens(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """The x_{t-1} stream: ``[B, S, D] -> [B, S, D]``; position 0 sees
    ``prev`` ``[B, D]`` (or zeros)."""
    first = (prev[:, None].to(x.dtype) if prev is not None
             else torch.zeros_like(x[:, :1]))
    return torch.cat([first, x[:, :-1]], dim=1)


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None,
                  prev: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal convolution ``[B, S, W] -> [B, S, W]`` with taps
    ``weight [width, W]`` (tap 0 the current token): the y of the JAX
    function's ``(y, new_prev)``.

    Written as the JAX function writes it, in x's dtype with the taps and
    the bias cast to it: tap 0 times x, then for each further tap one more
    token shift and its product added, the bias last.  Not ``F.conv1d``,
    which sums in another order and on the card runs through cuDNN in TF32
    by default.  Only the state-free form (``prev`` None, zero context) is
    ported; a carried context, and the ``new_prev`` a next call would carry
    in, belong to the Griffin serving slice.
    """
    if prev is not None:
        raise NotImplementedError(
            "a carried convolution context (prefill and decode) is ported "
            "with the Griffin serving slice (ROADMAP queue 1, item 13)")
    dt = x.dtype
    y = weight[0].to(dt) * x
    shifted = x
    for i in range(1, weight.shape[0]):
        shifted = shift_tokens(shifted)
        y = y + weight[i].to(dt) * shifted
    if bias is not None:
        y = y + bias.to(dt)
    return y
