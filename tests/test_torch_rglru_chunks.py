"""The windowed chunk scan of K6 (``csrc/rglru_fwd.cu``, ``csrc/rglru_bwd.cu``)
on the CPU.

``rglru_chunked_plain`` and ``rglru_bwd_chunked_plain`` transcribe the CUDA
kernels' pieces, windows, float64 aggregates and combine in torch ops.  Held
here (1) in float64 to the sequential ``rglru_plain`` and
``rglru_bwd_plain`` at ragged T (one token, fewer than a piece, part way
through a window), ragged W (1, 33, 130), brutal decay and with and without
the last state's cotangent, at the kernels' geometry and at a small one;
(2) in float32 to float64 at the card's row limit, so a combine that loses
digits fails here before it reaches the card; and (3) a backward that drops
the a_{t+1} or y_{t-1} lying across a window edge misses that limit by far.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.rglru import rglru_bwd_plain, rglru_plain
from repro_torch.kernels.rglru.ref import (
    PIECE,
    WINDOW,
    rglru_bwd_chunked_plain,
    rglru_chunked_plain,
)

# the card's row limit for K6 (chip_smoke.py RGLRU_ROW_RTOL)
CARD_ROW_RTOL = 1e-6
# float64 against float64, products in another order: ~1e-16 of a row
F64_ROW_RTOL = 1e-12

# (B, T, W, kind, piece, window): the kernels' geometry (pieces of 8,
# windows of 64) at T = 1, T < a piece, T = 4 windows + 43 (part way
# through a window's sixth piece) and one window exactly; a small geometry
# (3 pieces of 4) over many windows
CASES = [
    (1, 1, 33, "model", PIECE, WINDOW),
    (2, 7, 130, "model", PIECE, WINDOW),
    (2, 4 * WINDOW + 43, 33, "model", PIECE, WINDOW),
    (1, 4 * WINDOW + 43, 1, "brutal", PIECE, WINDOW),
    (1, WINDOW, 130, "long", PIECE, WINDOW),
    (2, 50, 33, "brutal", 4, 12),
]
IDS = ["T1", "T_lt_piece", "T_mid_window", "W1_brutal", "one_window_long", "small_geometry"]


def _inputs(B, T, W, kind, seed):
    """a, b, dy ``[B, T, W]`` and dh_last ``[B, W]``, float32 values in
    float64 tensors: Griffin's decays (log a = -8 softplus(lam) r), brutal
    decay (log a in [-12, 0]) or long memory (log a in [-1e-2, -1e-4]), as
    the card draws them (chip_smoke.py _rglru_inputs)."""
    rng = np.random.default_rng(seed)
    if kind == "brutal":
        log_a = -rng.uniform(0.0, 12.0, (B, T, W))
    elif kind == "long":
        log_a = -rng.uniform(1e-4, 1e-2, (B, T, W))
    else:
        lam = rng.uniform(-1.0, 1.0, W)
        r = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, W))))
        log_a = -8.0 * np.logaddexp(lam, 0.0) * r
    a = np.exp(log_a)
    b = np.sqrt(-np.expm1(2 * log_a)) * rng.standard_normal((B, T, W))
    dy = rng.standard_normal((B, T, W))
    dh = rng.standard_normal((B, W))
    return [torch.from_numpy(x.astype(np.float32)).double() for x in (a, b, dy, dh)]


def _row_err(x, ref):
    """As the card holds K6: largest over rows (one token's W channels) of
    max |x - ref| over the row's largest |ref|."""
    d = (x.double() - ref.double()).abs().amax(-1)
    m = ref.double().abs().amax(-1)
    return (d / m.clamp_min(1e-2 * m.median()).clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("B,T,W,kind,piece,window", CASES, ids=IDS)
def test_forward_chunks_match_the_sequential_walk(B, T, W, kind, piece, window):
    a, b, _, _ = _inputs(B, T, W, kind, seed=T + W)
    y, h_last = rglru_chunked_plain(a, b, piece=piece, window=window)
    ry, rh = rglru_plain(a, b)
    assert y.dtype == torch.float64
    assert _row_err(y, ry) <= F64_ROW_RTOL
    assert _row_err(h_last, rh) <= F64_ROW_RTOL
    assert torch.equal(h_last, y[:, -1])


@pytest.mark.parametrize("with_dh_last", [False, True], ids=["dy", "dy+dh_last"])
@pytest.mark.parametrize("B,T,W,kind,piece,window", CASES, ids=IDS)
def test_backward_chunks_match_the_sequential_walk(B, T, W, kind, piece, window,
                                                   with_dh_last):
    a, b, dy, dh = _inputs(B, T, W, kind, seed=3 * T + W)
    y, _ = rglru_plain(a, b)
    dh = dh if with_dh_last else None
    ours = rglru_bwd_chunked_plain(a, y, dy, dh, piece=piece, window=window)
    for x, ref in zip(ours, rglru_bwd_plain(a, y, dy, dh)):
        assert _row_err(x, ref) <= F64_ROW_RTOL


@pytest.mark.parametrize("kind", ["model", "brutal", "long"])
def test_float32_chunks_keep_the_card_row_limit(kind):
    """In float32, as the card runs it (float32 walks of at most a piece
    from carries combined in float64), every output stays within the card's
    limit of the float64 sequential walk, long memory included."""
    B, T, W = 2, 700, 48
    a, b, dy, dh = _inputs(B, T, W, kind, seed=31)
    ry, rh = rglru_plain(a, b)
    rda, rdb = rglru_bwd_plain(a, ry, dy, dh)
    y, h_last = rglru_chunked_plain(a.float(), b.float())
    da, db = rglru_bwd_chunked_plain(a.float(), y, dy.float(), dh.float())
    assert y.dtype == da.dtype == torch.float32
    errs = [_row_err(x, ref) for x, ref in ((y, ry), (h_last, rh), (da, rda), (db, rdb))]
    assert max(errs) <= CARD_ROW_RTOL, errs


@pytest.mark.parametrize("edge", ["a", "y"])
def test_card_limit_catches_a_dropped_window_edge(edge):
    """A backward that takes a_{t+1} = 0 at a window's last token (the row
    in the window above) or y_{t-1} = 0 at its first (the row in the window
    below) moves da or db by far more than the card's limit."""
    B, T, W = 2, 3 * WINDOW + 20, 64
    a, b, dy, dh = _inputs(B, T, W, "model", seed=41)
    y, _ = rglru_plain(a, b)
    ref = rglru_bwd_plain(a, y, dy, dh)
    dropped = rglru_bwd_chunked_plain(a, y, dy, dh, drop_window_edge=edge)
    moved = max(_row_err(x, r) for x, r in zip(dropped, ref))
    assert moved > 1e3 * CARD_ROW_RTOL, moved
