"""Flash-attention dispatch (K2): the CUDA kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``) for tensors on the card, the plain versions
(``ref.py``) for tensors on the CPU or when ``plain=True`` is asked.

The device of the tensors decides otherwise: a CUDA tensor launches its
kernel or raises (wrong dtype, layout, head dim, failed build or launch); it
never falls back to the plain version.  Each kernel wrapper adds one to
``launches[name]`` where it launches its kernel.  :class:`FlashAttention`
is the ``autograd.Function`` the model calls: its forward keeps ``lse`` for
its backward, as ``_make_flash``'s fwd keeps its residuals.  Each call
reports its products to :mod:`repro_torch.core.flops` while a train step's
flops are being counted, as no flop counter can see inside the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import flops
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_bwd_plain, flash_fwd_plain

launches = {"flash_fwd": 0, "flash_bwd": 0}
HEAD_DIMS = (16, 32, 64, 128, 256)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, lse, B, S, T, H, K, D, scale, causal, window, stream
    "flash_fwd": [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P],
    # q, k, v, o, dO, lse, scratch, dq, dk, dv, B, S, T, H, K, D, scale,
    # causal, window, stream
    "flash_bwd": [_P] * 10 + [_I] * 6 + [_F, _I, _I, _P],
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


def shared_memory_bytes(name: str, D: int) -> int:
    """Dynamic shared memory of one block (the backward's larger block)."""
    fn = getattr(_build.load(name), f"{name}_smem_bytes")
    fn.argtypes, fn.restype = [_I], ctypes.c_size_t
    return fn(D)


def _scratch_floats(B: int, S: int, H: int) -> int:
    """Float32 scratch of the backward: lse * log2(e) and delta, rows padded."""
    fn = getattr(_build.load("flash_bwd"), "flash_bwd_scratch_floats")
    fn.argtypes, fn.restype = [_I, _I, _I], ctypes.c_size_t
    return fn(B, S, H)


def _require(t: torch.Tensor, what: str, dtype: torch.dtype,
             shape: tuple[int, ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _geometry(q, k, v, **more):
    """Checks the operands (``more``: o and dO of the backward by name) and
    returns (B, S, T, H, K, D).  Alignment is checked first, before the
    device: the TMA unit reads every operand from a 16-byte-aligned base."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be [B, S, H, D] and k, v [B, T, K, D], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    for what, t in dict(q=q, k=k, v=v, **more).items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what} must start 16-byte aligned (TMA tile loads)")
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on the card, q is on {q.device}")
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not taken; the kernel takes {HEAD_DIMS}")
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    bf16 = torch.bfloat16
    _require(q, "q", bf16, (B, S, H, D), q.device)
    _require(k, "k", bf16, (B, T, K, D), q.device)
    _require(v, "v", bf16, (B, T, K, D), q.device)
    return B, S, T, H, K, D


def _window(window: int | None) -> int:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return -1 if window is None else int(window)


def flash_fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float, causal: bool = True, window: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward: -> (o ``[B, S, H, D]`` bf16, lse ``[B*H, S]`` f32)."""
    B, S, T, H, K, D = _geometry(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel("flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, S, T, H, K, D, float(scale), int(bool(causal)), _window(window), stream)
    if err:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    launches["flash_fwd"] += 1
    return o, lse


def flash_bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                     scale: float, causal: bool = True, window: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward: -> (dq, dk, dv), bf16, shaped like q, k, v."""
    B, S, T, H, K, D = _geometry(q, k, v, o=o, do=do)
    _require(o, "o", torch.bfloat16, tuple(q.shape), q.device)
    _require(do, "do", torch.bfloat16, tuple(q.shape), q.device)
    _require(lse, "lse", torch.float32, (B * H, S), q.device)
    scratch = torch.empty(_scratch_floats(B, S, H), dtype=torch.float32,
                          device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel("flash_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, S, T, H, K, D, float(scale), int(bool(causal)),
        _window(window), stream)
    if err:
        raise RuntimeError(f"flash_bwd launch failed: CUDA error {err}")
    launches["flash_bwd"] += 1
    return dq, dk, dv


def _use_plain(q: torch.Tensor, plain: bool) -> bool:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no flash-attention path for device {q.device}")
    return plain or q.device.type == "cpu"


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v); the backward recomputes p from the saved lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, plain):
        kw = dict(scale=scale, causal=causal, window=window)
        with flops.flash_call(q.shape, k.shape, causal=causal, window=window,
                              backward=False):
            if _use_plain(q, plain):
                o, lse = flash_fwd_plain(q, k, v, **kw)
            else:
                o, lse = flash_fwd_kernel(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.plain = kw, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        with flops.flash_call(q.shape, k.shape, causal=ctx.kw["causal"],
                              window=ctx.kw["window"], backward=True):
            if _use_plain(q, ctx.plain):
                grads = flash_bwd_plain(q, k, v, o, lse, do, **ctx.kw)
            else:
                grads = flash_bwd_kernel(q, k, v, o, lse, do.contiguous(),
                                         **ctx.kw)
        return (*grads, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int | None = None,
                    plain: bool = False) -> torch.Tensor:
    """Differentiable GQA flash attention in the model layout: q
    ``[B, S, H, D]``, k/v ``[B, T, K, D]`` -> ``[B, S, H, D]``."""
    if not _use_plain(q, plain):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return FlashAttention.apply(q, k, v, float(scale), bool(causal), window,
                                bool(plain))
