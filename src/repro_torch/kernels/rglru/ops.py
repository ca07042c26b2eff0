"""RG-LRU dispatch (K6): the CUDA kernels (``csrc/rglru_fwd.cu``,
``csrc/rglru_bwd.cu``) for tensors on the card, the plain versions
(``ref.py``) for tensors on the CPU or when ``plain=True`` is asked.

The device of the tensors decides otherwise: a CUDA tensor launches its
kernel or raises (a or b not float32, not contiguous, not ``[B, T, W]``,
on two devices, a failed build or launch); it never falls back to the
plain version.  A tensor on the ``meta`` device (the dryrun) passes the
same checks and gets what the kernel would return, with nothing launched.
A call launches one kernel, a windowed chunk scan with one
block per (batch row, 32 channels) and no scratch; each kernel wrapper adds
one to ``launches[name]`` where it launches its kernel.  :class:`RGLRUScan`
is the ``autograd.Function`` the model calls: it saves a and its output y,
from which the backward kernel needs no recompute.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru.ref import rglru_bwd_plain, rglru_plain

launches = {"rglru_fwd": 0, "rglru_bwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # a, b, y, h_last, B, T, W, stream
    "rglru_fwd": [_P] * 4 + [_I] * 3 + [_P],
    # a, y, dy, dh_last, da, db, B, T, W, stream
    "rglru_bwd": [_P] * 6 + [_I] * 3 + [_P],
}
_functions: dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _kernel(name: str):
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(_build.load(name), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def _require(t: torch.Tensor, what: str, shape: tuple[int, ...],
             device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what} is {t.dtype}, the kernel takes torch.float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _geometry(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int]:
    if a.dim() != 3:
        raise ValueError(f"a must be [B, T, W], got {tuple(a.shape)}")
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"the kernel runs on the card, a is on {a.device}")
    _require(a, "a", tuple(a.shape), a.device)
    _require(b, "b", tuple(a.shape), a.device)
    return tuple(a.shape)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def rglru_fwd_kernel(a: torch.Tensor, b: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward: -> (y ``[B, T, W]``, h_last ``[B, W]``), float32."""
    B, T, W = _geometry(a, b)
    y = torch.empty_like(a)
    h_last = torch.empty((B, W), dtype=torch.float32, device=a.device)
    if a.is_meta:
        _build.meta_calls.add("rglru_fwd")
        return y, h_last
    err = _kernel("rglru_fwd")(a.data_ptr(), b.data_ptr(), y.data_ptr(),
                               h_last.data_ptr(), B, T, W, _stream(a))
    if err:
        raise RuntimeError(f"rglru_fwd launch failed: CUDA error {err}")
    launches["rglru_fwd"] += 1
    return y, h_last


def rglru_bwd_kernel(a: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                     dh_last: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward from the forward output ``y``: -> (da, db),
    float32 ``[B, T, W]``; ``dh_last`` None is a zero cotangent."""
    B, T, W = _geometry(a, y)
    _require(dy, "dy", (B, T, W), a.device)
    if dh_last is not None:
        _require(dh_last, "dh_last", (B, W), a.device)
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.is_meta:
        _build.meta_calls.add("rglru_bwd")
        return da, db
    err = _kernel("rglru_bwd")(
        a.data_ptr(), y.data_ptr(), dy.data_ptr(),
        None if dh_last is None else dh_last.data_ptr(), da.data_ptr(),
        db.data_ptr(), B, T, W, _stream(a))
    if err:
        raise RuntimeError(f"rglru_bwd launch failed: CUDA error {err}")
    launches["rglru_bwd"] += 1
    return da, db


def _use_plain(a: torch.Tensor, plain: bool) -> bool:
    if a.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no rglru path for device {a.device}")
    return plain or a.device.type == "cpu"


class RGLRUScan(torch.autograd.Function):
    """(y, h_last) = the recurrence from zero; saves a and y."""

    @staticmethod
    def forward(ctx, a, b, plain):
        if _use_plain(a, plain):
            y, h_last = rglru_plain(a, b)
        else:
            y, h_last = rglru_fwd_kernel(a, b)
        ctx.save_for_backward(a, y)
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        a, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        if _use_plain(a, ctx.plain):
            da, db = rglru_bwd_plain(a, y, dy, dh_last)
        else:
            da, db = rglru_bwd_kernel(
                a, y, dy.contiguous(),
                None if dh_last is None else dh_last.contiguous())
        return da, db, None


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None,
               *, plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable ``h_t = a_t h_{t-1} + b_t`` from a zero state, a, b
    float32 ``[B, T, W]`` -> (h ``[B, T, W]``, h_last ``[B, W]``), float32:
    ``repro.kernels.rglru.ops.rglru_scan`` without its clamp (P7)."""
    if h0 is not None:
        raise NotImplementedError(
            "K6 scans from a zero state, as the Pallas kernel's caller only "
            "ever asks it to; a carried h0 (prefill and decode) goes to "
            "models.scan_utils.lru_scan")
    if not _use_plain(a, plain):
        a, b = a.contiguous(), b.contiguous()
    return RGLRUScan.apply(a, b, bool(plain))
