"""Flash-attention dispatch (K2): the CUDA kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``) for tensors on the card, the plain versions
(``ref.py``) for tensors on the CPU or when ``plain=True`` is asked.

The device of the tensors decides otherwise: a CUDA tensor launches its
kernel or raises (wrong dtype, layout, head dim, failed build or launch); it
never falls back to the plain version.  A tensor on the ``meta`` device (the
dryrun) passes the same checks and gets what the kernel would return (o,
lse; dq, dk, dv), allocated as the wrapper allocates it, the backward's
scratch included, with nothing launched.  Each kernel wrapper adds one to
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
# the (q/k head dim, v head dim) pairs the kernels take (FLASH_PAIRS in
# csrc/flash_sm90.cuh): every D = D of HEAD_DIMS, MLA's (192, 128) and the
# MLA smoke config's (24, 16)
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128), (24, 16))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, lse, B, S, T, H, K, D, DV, scale, causal, window, stream
    "flash_fwd": [_P] * 5 + [_I] * 7 + [_F, _I, _I, _P],
    # q, k, v, o, dO, lse, scratch, dq, dk, dv, B, S, T, H, K, D, DV, scale,
    # causal, window, stream
    "flash_bwd": [_P] * 10 + [_I] * 7 + [_F, _I, _I, _P],
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


def shared_memory_bytes(name: str, D: int, Dv: int | None = None) -> int:
    """Dynamic shared memory of one block (the backward's larger block) at
    q's head dim ``D`` and v's ``Dv`` (default ``D``)."""
    fn = getattr(_build.load(name), f"{name}_smem_bytes")
    fn.argtypes, fn.restype = [_I, _I], ctypes.c_size_t
    return fn(D, D if Dv is None else Dv)


def meta_scratch_floats(B: int, S: int, H: int) -> int:
    """``flash_bwd_scratch_floats`` without the library, for the meta
    device: two float32 rows of S rounded up to the kernels' 64-query
    step for each (batch, head)."""
    return 2 * B * H * (-(-S // 64) * 64)


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
    """Checks the operands (``more``: o and dO of the backward by name,
    shaped ``[B, S, H, Dv]``) and returns (B, S, T, H, K, D, Dv).  Alignment
    (the TMA unit reads every operand from a 16-byte-aligned base), the head
    dims and the shapes are checked before the device, so the refusals show
    on CPU tensors too."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q must be [B, S, H, D], k [B, T, K, D] and v "
                         f"[B, T, K, Dv], got {tuple(q.shape)}, {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    for what, t in dict(q=q, k=k, v=v, **more).items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what} must start 16-byte aligned (TMA tile loads)")
    B, S, H, D = q.shape
    T, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    if (D, Dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head dims (q/k {D}, v {Dv}) not taken; the kernel "
                         f"takes (D, Dv) in {HEAD_DIM_PAIRS}")
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    bf16 = torch.bfloat16
    _require(q, "q", bf16, (B, S, H, D), q.device)
    _require(k, "k", bf16, (B, T, K, D), q.device)
    _require(v, "v", bf16, (B, T, K, Dv), q.device)
    for what, t in more.items():
        _require(t, what, bf16, (B, S, H, Dv), q.device)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"the kernel runs on the card, q is on {q.device}")
    return B, S, T, H, K, D, Dv


def _window(window: int | None) -> int:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return -1 if window is None else int(window)


def flash_fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float, causal: bool = True, window: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward: -> (o ``[B, S, H, Dv]`` bf16, lse ``[B*H, S]`` f32)."""
    B, S, T, H, K, D, Dv = _geometry(q, k, v)
    o = q.new_empty((B, S, H, Dv))
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    if q.is_meta:
        _build.meta_calls.add("flash_fwd")
        return o, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel("flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, S, T, H, K, D, Dv, float(scale), int(bool(causal)), _window(window),
        stream)
    if err:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    launches["flash_fwd"] += 1
    return o, lse


def flash_bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                     scale: float, causal: bool = True, window: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward: -> (dq, dk, dv), bf16, shaped like q, k, v (o
    and dO ``[B, S, H, Dv]``)."""
    B, S, T, H, K, D, Dv = _geometry(q, k, v, o=o, do=do)
    _require(lse, "lse", torch.float32, (B * H, S), q.device)
    scratch = torch.empty(
        meta_scratch_floats(B, S, H) if q.is_meta else _scratch_floats(B, S, H),
        dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.is_meta:
        _build.meta_calls.add("flash_bwd")
        return dq, dk, dv
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel("flash_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, S, T, H, K, D, Dv, float(scale), int(bool(causal)),
        _window(window), stream)
    if err:
        raise RuntimeError(f"flash_bwd launch failed: CUDA error {err}")
    launches["flash_bwd"] += 1
    return dq, dk, dv


def _use_plain(q: torch.Tensor, plain: bool) -> bool:
    if q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no flash-attention path for device {q.device}")
    return plain or q.device.type == "cpu"


class FlashAttention(torch.autograd.Function):
    """o ``[B, S, H, Dv]`` = attention(q, k, v); the backward recomputes p
    from the saved lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, plain):
        kw = dict(scale=scale, causal=causal, window=window)
        with flops.flash_call(q.shape, k.shape, causal=causal, window=window,
                              backward=False, dv=v.shape[-1]):
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
                              window=ctx.kw["window"], backward=True,
                              dv=v.shape[-1]):
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
    ``[B, S, H, D]``, k ``[B, T, K, D]``, v ``[B, T, K, Dv]`` -> ``[B, S,
    H, Dv]`` (``Dv`` apart from ``D`` as MLA takes it: the pairs of
    ``HEAD_DIM_PAIRS`` on the card)."""
    if not _use_plain(q, plain):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return FlashAttention.apply(q, k, v, float(scale), bool(causal), window,
                                bool(plain))
