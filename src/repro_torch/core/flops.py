"""Model flops of one train step: the numerator of the MFU estimate.

The JAX package takes XLA's cost analysis of the compiled step
(``repro.train.loop._step_flops``); PyTorch has none.  The port counts the
matrix products that one forward and backward of the step's loss runs with
``torch.utils.flop_counter.FlopCounterMode``, which sees every aten product
(``mm``, ``addmm``, ``bmm``, the einsums' products), the recompute of full
remat included, as it runs in the backward.  It cannot see K2, a CUDA
kernel behind an ``autograd.Function``: each K2 call reports its products
here instead (:func:`flash_call`), by the causal formula of its bound:
each product counts 2 flops a query-key pair per column of its depth or
width, q's head dim d for Q K^T (recomputed in the backward), dQ and dK,
v's dv for P V, dP and dV, so 2·(d + dv) forward and 2·(3d + 2dv) backward
(4·d and 10·d where dv = d).  On the CPU the products of its plain version
are taken back out, so the count is the same wherever the step runs.

Products only: no elementwise work and no optimizer, so the count is not
expected to equal XLA's, which counts every operation.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import Callable, Iterator

from torch.utils.flop_counter import FlopCounterMode


class _Count:
    def __init__(self):
        self.flash = 0   # K2's products, by formula
        self.plain = 0   # what the counter saw inside K2's plain versions


_active: list[_Count] = []


def causal_pairs(S: int, T: int, causal: bool, window: int | None) -> int:
    """Query-key pairs one head sees: query i (at position i) attends to
    keys j <= i within ``window`` when causal, to all T otherwise."""
    if not causal:
        return S * T
    w = T if window is None else min(window, T)
    # sum over i of min(i + 1, w), for i < S
    full = min(S, w)
    return full * (full + 1) // 2 + (S - full) * w


def flash_flops(q_shape, k_shape, *, causal: bool, window: int | None,
                backward: bool, dv: int | None = None) -> int:
    """K2's products: q ``[B, S, H, D]``, k ``[B, T, K, D]``, v's head dim
    ``dv`` (default ``D``)."""
    B, S, H, D = q_shape
    dv = D if dv is None else dv
    per_pair = 2 * (3 * D + 2 * dv) if backward else 2 * (D + dv)
    return per_pair * B * H * causal_pairs(S, k_shape[1], causal, window)


def flash_call(q_shape, k_shape, *, causal: bool, window: int | None,
               backward: bool, dv: int | None = None):
    """Context around one K2 call (forward or backward): while a step is
    being counted, adds the call's products by formula and keeps what its
    plain version computes out of the count; otherwise does nothing."""
    if not _active:
        return nullcontext()
    _active[-1].flash += flash_flops(q_shape, k_shape, causal=causal,
                                     window=window, backward=backward, dv=dv)
    return _excluded(_active[-1])


@contextmanager
def _excluded(count: _Count) -> Iterator[None]:
    with FlopCounterMode(display=False) as inner:
        yield
    count.plain += inner.get_total_flops()


def count_flops(fn: Callable[[], object]) -> int:
    """Products of ``fn()`` (a forward and backward), K2 by formula."""
    count = _Count()
    _active.append(count)
    try:
        with FlopCounterMode(display=False) as outer:
            fn()
    finally:
        _active.pop()
    return outer.get_total_flops() - count.plain + count.flash
