"""WKV6 dispatch (K5): the CUDA kernels (``csrc/wkv6_fwd.cu``,
``csrc/wkv6_bwd.cu``) for tensors on the card, the plain version
(``ref.py``) for tensors on the CPU or when ``plain=True`` is asked.

The device of the tensors decides otherwise: a CUDA tensor launches its
kernel or raises (r, k, v not bfloat16, w or u not float32, a head size the
kernels do not take, a failed build or launch); it never falls back to the
plain version.  Each kernel wrapper adds one to ``launches[name]`` where it
launches its kernel.  :class:`WKV6` is the ``autograd.Function`` the model
calls: it saves its inputs, and its backward recomputes the states.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6.ref import wkv6_plain

launches = {"wkv6_fwd": 0, "wkv6_bwd": 0}
HEAD_SIZES = (16, 64)  # the smoke configs' and rwkv6-3b's

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # r, k, v, w, u, y, s, BH, T, H, N, stream
    "wkv6_fwd": [_P] * 7 + [_I] * 4 + [_P],
    # r, k, v, w, u, dy, dr, dk, dv, dw, du_row, ckpt, BH, T, H, N, stream
    "wkv6_bwd": [_P] * 12 + [_I] * 4 + [_P],
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


def _c_fn(name: str, symbol: str, argtypes: list, restype):
    fn = getattr(_build.load(name), symbol)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


def shared_memory_bytes(name: str, N: int) -> int:
    """Shared memory of one block at head size ``N`` (static for the
    forward, dynamic for the backward)."""
    return _c_fn(name, f"{name}_smem_bytes", [_I], ctypes.c_size_t)(N)


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


def _geometry(r, k, v, w, u) -> tuple[int, int, int, int]:
    if r.dim() != 3 or u.dim() != 2:
        raise ValueError(f"r must be [B*H, T, N] and u [H, N], got "
                         f"{tuple(r.shape)} and {tuple(u.shape)}")
    if r.device.type != "cuda":
        raise ValueError(f"the kernel runs on the card, r is on {r.device}")
    BH, T, N = r.shape
    H = u.shape[0]
    if N not in HEAD_SIZES:
        raise ValueError(f"head size {N} not taken; the kernels take {HEAD_SIZES}")
    if T < 1 or H < 1 or BH % H:
        raise ValueError(f"{BH} rows of {T} tokens do not split into {H} heads")
    bf16, f32 = torch.bfloat16, torch.float32
    for t, what in ((r, "r"), (k, "k"), (v, "v")):
        _require(t, what, bf16, (BH, T, N), r.device)
    _require(w, "w", f32, (BH, T, N), r.device)
    _require(u, "u", f32, (H, N), r.device)
    return BH, T, H, N


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def wkv6_fwd_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward: -> (y ``[B*H, T, N]``, final state ``[B*H, N,
    N]``), both float32."""
    BH, T, H, N = _geometry(r, k, v, w, u)
    y = torch.empty((BH, T, N), dtype=torch.float32, device=r.device)
    s = torch.empty((BH, N, N), dtype=torch.float32, device=r.device)
    err = _kernel("wkv6_fwd")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), s.data_ptr(), BH, T, H, N, _stream(r))
    if err:
        raise RuntimeError(f"wkv6_fwd launch failed: CUDA error {err}")
    launches["wkv6_fwd"] += 1
    return y, s


def wkv6_bwd_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor):
    """Launch the backward for a cotangent ``dy`` of y (the final state's
    is zero): -> (dr, dk, dv bf16; dw float32 ``[B*H, T, N]``; du float32
    ``[H, N]``, summed over the batch in a fixed order)."""
    BH, T, H, N = _geometry(r, k, v, w, u)
    _require(dy, "dy", torch.float32, (BH, T, N), r.device)
    chunk = _c_fn("wkv6_bwd", "wkv6_bwd_chunk", [], ctypes.c_int)()
    ckpt = torch.empty((BH * (-(-T // chunk)) * N * N,), dtype=torch.float32,
                       device=r.device)
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw = torch.empty_like(w)
    du_row = torch.empty((BH, N), dtype=torch.float32, device=r.device)
    err = _kernel("wkv6_bwd")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        dy.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
        du_row.data_ptr(), ckpt.data_ptr(), BH, T, H, N, _stream(r))
    if err:
        raise RuntimeError(f"wkv6_bwd launch failed: CUDA error {err}")
    launches["wkv6_bwd"] += 1
    return dr, dk, dv, dw, du_row.view(BH // H, H, N).sum(0)


class WKV6(torch.autograd.Function):
    """(y, final state) = wkv6(r, k, v, w, u) on the card; the backward
    kernel recomputes the states from the saved inputs.  The final state
    takes no gradient (the training path discards it)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        y, s = wkv6_fwd_kernel(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.set_materialize_grads(False)
        return y, s

    @staticmethod
    def backward(ctx, dy, dstate):
        if dstate is not None:
            raise NotImplementedError(
                "a gradient through the WKV final state (a carried state) is "
                "ported with the RWKV serving slice (ROADMAP queue 1, item 13)")
        r, k, v, w, u = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        return wkv6_bwd_kernel(r, k, v, w, u, dy.contiguous())


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, *, plain: bool = False
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable WKV6 from a zero state in the model layout: r, k, w
    ``[B, T, H, K]``, v ``[B, T, H, V]``, u ``[H, K]`` -> (y ``[B, T, H,
    V]`` float32, final state ``[B, H, K, V]`` float32).  Rows go to the
    ``[B*H, T, K]`` layout of ``repro.kernels.wkv6.ops.wkv6`` and back."""
    if r.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no wkv6 path for device {r.device}")
    B, T, H, K = r.shape
    V = v.shape[-1]

    def to_bh(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 1, 3).reshape(B * H, T, x.shape[-1])

    args = (to_bh(r), to_bh(k), to_bh(v), to_bh(w), u)
    if plain or r.device.type == "cpu":
        y, s = wkv6_plain(*args)
    else:
        y, s = WKV6.apply(*(a.contiguous() for a in args))
    return y.view(B, H, T, V).permute(0, 2, 1, 3), s.view(B, H, K, V)
