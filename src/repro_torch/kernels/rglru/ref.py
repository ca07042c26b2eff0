"""Plain PyTorch versions of the RG-LRU kernel (K6), forward and backward.

``rglru_plain`` is ``repro.kernels.rglru.ref.rglru_ref`` from a zero state in
torch ops: the diagonal recurrence

    h_t = a_t * h_{t-1} + b_t,   h_{-1} = 0,

walked one token at a time in float32 (float64 when ``a`` is float64),
exact and unclamped.  The Pallas kernel clips log a to [-2, 0]
(``kernel.py:38``, R2) and the port does not: Griffin's decays lie below
e^-2 in most channels at init (P7).  ``rglru_bwd_plain`` is the reverse
walk of the same recurrence, what the CUDA backward is held to on the card:

    g_t = dy_t + a_{t+1} g_{t+1}   (plus dh_last at t = T-1),
    db_t = g_t,   da_t = g_t * h_{t-1}.

Layout as ``rglru_pallas``: a, b, y ``[B, T, W]``, the last state ``[B,
W]``.  These run on whatever device their inputs live on; the card checks
hand them float64 copies.
"""

from __future__ import annotations

import torch


def _dtype(a: torch.Tensor) -> torch.dtype:
    return torch.float64 if a.dtype == torch.float64 else torch.float32


def rglru_plain(a: torch.Tensor, b: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (y ``[B, T, W]``, h_last ``[B, W]``), float32 (float64 for float64
    a)."""
    ct = _dtype(a)
    a, b = a.to(ct), b.to(ct)
    h = torch.zeros_like(a[:, 0])
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1), h


def rglru_bwd_plain(a: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                    dh_last: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(da, db) of :func:`rglru_plain` for cotangents ``dy`` of y and
    ``dh_last`` of the last state (None: zero), given the forward output
    ``y``; float32 (float64 for float64 a)."""
    ct = _dtype(a)
    a, y, dy = a.to(ct), y.to(ct), dy.to(ct)
    T = a.shape[1]
    carry = (dh_last.to(ct) if dh_last is not None
             else torch.zeros_like(a[:, 0]))
    da, db = torch.empty_like(a), torch.empty_like(a)
    for t in range(T - 1, -1, -1):
        g = dy[:, t] + carry
        db[:, t] = g
        da[:, t] = g * y[:, t - 1] if t else 0.0
        carry = a[:, t] * g
    return da, db
