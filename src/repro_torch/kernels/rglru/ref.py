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

``rglru_chunked_plain`` and ``rglru_bwd_chunked_plain`` transcribe the CUDA
kernels' windowed chunk scan (``csrc/rglru_fwd.cu``, ``csrc/rglru_bwd.cu``)
for the tests: the same pieces, windows, float64 aggregates and combine.
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


# the kernels' geometry (csrc/rglru_common.cuh): a window of WARPS pieces
PIECE, WINDOW = 8, 64


def _pieces(t0: int, window: int, piece: int, T: int) -> list[range]:
    """The window's pieces from token t0, each cut at T (the kernels pad
    past T with tokens that leave the state as it is)."""
    return [range(s, min(s + piece, T)) for s in range(t0, t0 + window, piece)]


def rglru_chunked_plain(a: torch.Tensor, b: torch.Tensor, *, piece: int = PIECE,
                        window: int = WINDOW) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward's windowed chunk scan in torch ops: ``(y, h_last)`` as
    :func:`rglru_plain` gives them, in a's float type (float32, or float64
    for float64 a).

    T is walked in windows of ``window`` tokens, each cut into pieces of
    ``piece`` (one per warp).  Per window:
    (1) each piece's aggregate from a zero state in float64, ``A = prod a``
    and ``B`` = its scan end; (2) the combine, in piece order and float64:
    the state entering piece k is ``c_k = A_{k-1} c_{k-1} + B_{k-1}`` from
    the previous window's last state, which stays float64; (3) each piece
    walks again from its carry rounded to a's float type, ``h = a h + b``,
    and writes y.  h_last is y at T - 1.
    """
    ct = _dtype(a)
    a, b = a.to(ct), b.to(ct)
    T = a.shape[1]
    y = torch.empty_like(a)
    carry = torch.zeros_like(a[:, 0], dtype=torch.float64)
    for t0 in range(0, T, window):
        pieces = _pieces(t0, window, piece, T)
        starts = []
        for p in pieces:                      # (2) the combine, after (1)
            A = torch.ones_like(carry)
            Bk = torch.zeros_like(carry)
            for t in p:                       # (1) the piece's aggregate
                a64 = a[:, t].double()
                A = A * a64
                Bk = a64 * Bk + b[:, t].double()
            starts.append(carry)
            carry = A * carry + Bk
        for p, c in zip(pieces, starts):      # (3) the second walk
            h = c.to(ct)
            for t in p:
                h = a[:, t] * h + b[:, t]
                y[:, t] = h
    return y, y[:, -1].clone()


def rglru_bwd_chunked_plain(a: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                            dh_last: torch.Tensor | None = None, *,
                            piece: int = PIECE, window: int = WINDOW,
                            drop_window_edge: str | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward's windowed chunk scan in torch ops: ``(da, db)`` as
    :func:`rglru_bwd_plain` gives them, in a's float type.

    The windows and pieces of :func:`rglru_chunked_plain`, walked from the
    top.  Token t of a piece takes ``m_t = a_{t+1}`` (1 from T - 1 on: the
    carry entering the top window is dh_last), ``y_{t-1}`` (0 at t = 0) and
    ``dy_t`` (0 past T), so ``g_t = m_t g_{t+1} + dy_t``.  Per window: each
    piece's aggregate from a zero carry in float64 (``M = prod m``, ``G`` =
    its reverse scan end), the combine from the top piece down in float64
    from the later window's carry, then each piece's second walk from its
    carry rounded to a's float type: ``db_t = g_t``, ``da_t = g_t y_{t-1}``.

    ``drop_window_edge`` makes the fault the tests must catch: ``"a"``
    takes ``a_{t+1} = 0`` for the last token of a window (the row that lies
    in the window above), ``"y"`` takes ``y_{t-1} = 0`` for its first (the
    row in the window below).
    """
    ct = _dtype(a)
    a, y, dy = a.to(ct), y.to(ct), dy.to(ct)
    T = a.shape[1]
    one, zero = torch.ones_like(a[:, 0]), torch.zeros_like(a[:, 0])

    def m(t):
        if drop_window_edge == "a" and t % window == window - 1 and t + 1 < T:
            return zero
        return a[:, t + 1] if t + 1 < T else one

    def y_prev(t):
        if t == 0 or (drop_window_edge == "y" and t % window == 0):
            return zero
        return y[:, t - 1]

    da, db = torch.empty_like(a), torch.empty_like(a)
    carry = (dh_last.double() if dh_last is not None
             else torch.zeros_like(a[:, 0], dtype=torch.float64))
    for t0 in reversed(range(0, T, window)):
        pieces = _pieces(t0, window, piece, T)
        starts = []
        for p in reversed(pieces):            # the combine, from the top
            M = torch.ones_like(carry)
            G = torch.zeros_like(carry)
            for t in reversed(p):             # the piece's aggregate
                m64 = m(t).double()
                M = M * m64
                G = m64 * G + dy[:, t].double()
            starts.append(carry)
            carry = M * carry + G
        for p, c in zip(reversed(pieces), starts):  # the second walk
            g = c.to(ct)
            for t in reversed(p):
                g = m(t) * g + dy[:, t]
                db[:, t] = g
                da[:, t] = g * y_prev(t)
    return da, db
