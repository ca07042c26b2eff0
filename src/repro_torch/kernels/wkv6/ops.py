"""WKV6 dispatch (K5): the CUDA kernels (``csrc/wkv6_fwd.cu``,
``csrc/wkv6_bwd.cu``) for tensors on the card, the plain version
(``ref.py``) for tensors on the CPU or when ``plain=True`` is asked.

The device of the tensors decides otherwise: a CUDA tensor launches its
kernel or raises (r, k, v not bfloat16, w or u not float32, a head size the
kernels do not take, a layout they cannot read, a failed build or launch);
it never falls back to the plain version.  A tensor on the ``meta`` device
(the dryrun) passes the same checks and gets what the kernels would return,
allocated as the wrapper allocates it (the chunk states and their scratch),
with nothing launched.  Each kernel wrapper adds one to
``launches[name]`` per call, however many kernels the call launches.
:class:`WKV6` is the ``autograd.Function`` the model calls, on every
device: it saves its inputs, its backward recomputes the chunk states (the
plain backward, the plain forward's graph), and each call reports its
products to ``core.flops`` by formula.

The kernels read r, k, v, w and dy where they lie, through their strides:
``[B*H, T, N]`` rows (the tests' and ``repro.kernels.wkv6``'s layout) or the
model's ``[B, T, H, N]``; outputs come back in the layout of r.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import flops
from repro_torch.kernels import _build
from repro_torch.kernels.wkv6.ref import wkv6_bwd_plain, wkv6_plain

launches = {"wkv6_fwd": 0, "wkv6_bwd": 0}
HEAD_SIZES = (16, 64)  # the smoke configs' and rwkv6-3b's
# kernels each forward and backward call launches, in order (the parts of
# wkv6_{fwd,bwd}_smem_bytes)
PARTS = {"wkv6_fwd": ("wkv6_chunk_state_kernel", "wkv6_scan_kernel", "wkv6_fwd_out_kernel"),
         "wkv6_bwd": ("wkv6_chunk_state_kernel", "wkv6_scan_kernel", "wkv6_bwd_grad_kernel")}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # r, k, v, w, u, y, s, states, a, BH, T, H, N, (sb, sh, st) of r, of y, stream
    "wkv6_fwd": [_P] * 9 + [_I] * 4 + [_L] * 6 + [_P],
    # r, k, v, w, u, dy, dr, dk, dv, dw, du_part, S, D, a, BH, T, H, N,
    # (sb, sh, st) of r, of dy, of the gradients, stream
    "wkv6_bwd": [_P] * 14 + [_I] * 4 + [_L] * 9 + [_P],
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


def shared_memory_bytes(name: str, N: int) -> dict[str, int]:
    """Dynamic shared memory of one block of each kernel a ``name`` call
    launches, at head size ``N``."""
    fn = _c_fn(name, f"{name}_smem_bytes", [_I, _I], ctypes.c_size_t)
    return {kern: fn(N, part) for part, kern in enumerate(PARTS[name])}


#: tokens a chunk (``CHUNK`` of ``csrc/wkv6_common.cuh``): the meta
#: device's chunk count, where no library is loaded
META_CHUNK = 64


def _chunks(name: str, BH: int, T: int, meta: bool = False) -> int:
    """Chunks a row of T tokens: the grid of a chunk kernel has one block
    per (row, chunk), on gridDim.x, which holds at most 2^31 - 1."""
    chunk = META_CHUNK if meta else _c_fn(name, f"{name}_chunk", [], ctypes.c_int)()
    nc = -(-T // chunk)
    if nc * BH > 2**31 - 1:
        raise ValueError(f"{BH} rows of {nc} chunks exceed a grid of 2^31 - 1 blocks")
    return nc


def _strides(t: torch.Tensor, H: int) -> tuple[int, int, int]:
    """(sb, sh, st): element (b, h, t, n) of ``t`` lies at b sb + h sh +
    t st + n, for ``[B*H, T, N]`` rows or ``[B, T, H, N]``."""
    if t.dim() == 3:
        return H * t.stride(0), t.stride(0), t.stride(1)
    return t.stride(0), t.stride(2), t.stride(1)


def _rows_aligned(t: torch.Tensor) -> bool:
    """Contiguous channels and every row 16-byte aligned: what the kernels'
    16-byte copies read."""
    return t.stride(-1) == 1 and not t.data_ptr() % 16 and not any(
        s * t.element_size() % 16 for s in t.stride()[:-1])


def _require(t: torch.Tensor, what: str, dtype: torch.dtype,
             shape: tuple[int, ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {shape}")
    if not _rows_aligned(t):
        raise ValueError(f"{what} needs contiguous channels and 16-byte aligned rows, "
                         f"strides {t.stride()}")


def _geometry(r, k, v, w, u) -> tuple[int, int, int, int]:
    """(B*H, T, H, N) of ``[B*H, T, N]`` or ``[B, T, H, N]`` inputs; r, k,
    v and w must share one layout."""
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"the kernel runs on the card, r is on {r.device}")
    if r.dim() not in (3, 4) or u.dim() != 2:
        raise ValueError(f"r must be [B*H, T, N] or [B, T, H, N] and u [H, N], got "
                         f"{tuple(r.shape)} and {tuple(u.shape)}")
    H, N = u.shape
    if r.dim() == 3:
        BH, T, _ = r.shape
        if T < 1 or H < 1 or BH % H:
            raise ValueError(f"{BH} rows of {T} tokens do not split into {H} heads")
    else:
        B, T, H4, _ = r.shape
        if H4 != H or T < 1:
            raise ValueError(f"{H4} heads of {T} tokens, but u has {H} heads")
        BH = B * H
    if r.shape[-1] not in HEAD_SIZES or N != r.shape[-1]:
        raise ValueError(f"head size {r.shape[-1]} not taken; the kernels take {HEAD_SIZES}")
    bf16, f32 = torch.bfloat16, torch.float32
    for t, what in ((r, "r"), (k, "k"), (v, "v")):
        _require(t, what, bf16, tuple(r.shape), r.device)
    _require(w, "w", f32, tuple(r.shape), r.device)
    _require(u, "u", f32, (H, N), r.device)
    if any(t.stride() != r.stride() for t in (k, v, w)):
        raise ValueError("r, k, v and w must share one layout")
    return BH, T, H, N


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def wkv6_fwd_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward: -> (y float32 in r's shape, final state float32
    ``[B*H, N, N]``, or ``[B, H, N, N]`` for ``[B, T, H, N]`` inputs)."""
    BH, T, H, N = _geometry(r, k, v, w, u)
    nc = _chunks("wkv6_fwd", BH, T, r.is_meta)
    dev = r.device
    y = torch.empty(r.shape, dtype=torch.float32, device=dev)
    s = torch.empty((BH, N, N) if r.dim() == 3 else (BH // H, H, N, N),
                    dtype=torch.float32, device=dev)
    states = torch.empty((BH, nc, N, N), dtype=torch.float32, device=dev)
    a = torch.empty((BH, nc, N), dtype=torch.float32, device=dev)
    if r.is_meta:
        _build.meta_calls.add("wkv6_fwd")
        return y, s
    err = _kernel("wkv6_fwd")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), s.data_ptr(), states.data_ptr(), a.data_ptr(), BH, T, H, N,
        *_strides(r, H), *_strides(y, H), _stream(r))
    if err:
        raise RuntimeError(f"wkv6_fwd launch failed: CUDA error {err}")
    launches["wkv6_fwd"] += 1
    return y, s


def wkv6_bwd_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor):
    """Launch the backward for a cotangent ``dy`` of y (float32, r's shape,
    any layout with contiguous channels; the final state's cotangent is
    zero): -> (dr, dk, dv bf16; dw float32, in r's shape; du float32
    ``[H, N]``, summed over chunks and the batch in a fixed order)."""
    BH, T, H, N = _geometry(r, k, v, w, u)
    _require(dy, "dy", torch.float32, tuple(r.shape), r.device)
    nc = _chunks("wkv6_bwd", BH, T, r.is_meta)
    dev = r.device
    dr, dk, dv = (torch.empty(r.shape, dtype=torch.bfloat16, device=dev) for _ in range(3))
    dw = torch.empty(r.shape, dtype=torch.float32, device=dev)
    du_part = torch.empty((BH, nc, N), dtype=torch.float32, device=dev)
    S, D = (torch.empty((BH, nc, N, N), dtype=torch.float32, device=dev) for _ in range(2))
    a = torch.empty((BH, nc, N), dtype=torch.float32, device=dev)
    if r.is_meta:
        _build.meta_calls.add("wkv6_bwd")
        return dr, dk, dv, dw, du_part.sum(1).view(BH // H, H, N).sum(0)
    err = _kernel("wkv6_bwd")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        dy.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
        du_part.data_ptr(), S.data_ptr(), D.data_ptr(), a.data_ptr(), BH, T, H, N,
        *_strides(r, H), *_strides(dy, H), *_strides(dr, H), _stream(r))
    if err:
        raise RuntimeError(f"wkv6_bwd launch failed: CUDA error {err}")
    launches["wkv6_bwd"] += 1
    return dr, dk, dv, dw, du_part.sum(1).view(BH // H, H, N).sum(0)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``[B, T, H, N]`` -> the plain version's ``[B*H, T, N]`` rows."""
    B, T, H, N = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, T, N)


def _model(x: torch.Tensor, B: int) -> torch.Tensor:
    """``[B*H, T, N]`` rows -> ``[B, T, H, N]``."""
    BH, T, N = x.shape
    return x.view(B, BH // B, T, N).permute(0, 2, 1, 3)


def _flops(r: torch.Tensor, v: torch.Tensor, backward: bool):
    B, T, H, K = r.shape
    return flops.kernel_call(lambda: flops.wkv6_flops(B, T, H, K, v.shape[-1],
                                                      backward=backward))


class WKV6(torch.autograd.Function):
    """(y, final state) = wkv6(r, k, v, w, u) in the model layout: the
    kernels on the card (the backward recomputes the chunk states from the
    saved inputs), the plain versions on the CPU or under ``plain``.  Each
    call reports its products to :mod:`repro_torch.core.flops`, as no flop
    counter can see inside the kernel.  The final state takes no gradient
    (the training path discards it)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, plain):
        with _flops(r, v, backward=False):
            if plain or r.device.type == "cpu":
                B, _, H, K = r.shape
                y, s = wkv6_plain(_rows(r), _rows(k), _rows(v), _rows(w), u)
                y, s = _model(y, B), s.view(B, H, K, v.shape[-1])
            else:
                y, s = wkv6_fwd_kernel(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        return y, s

    @staticmethod
    def backward(ctx, dy, dstate):
        if dstate is not None:
            raise NotImplementedError(
                "K5 takes no gradient through the WKV final state: training "
                "discards it, and a carried state (serving) runs "
                "models.scan_utils.wkv6_chunked without gradients")
        r, k, v, w, u = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(v.shape, dtype=torch.float32, device=r.device)
        with _flops(r, v, backward=True):
            if ctx.plain or r.device.type == "cpu":
                B = r.shape[0]
                grads = wkv6_bwd_plain(_rows(r), _rows(k), _rows(v), _rows(w), u,
                                       _rows(dy))
                grads = (*(_model(g, B) for g in grads[:4]), grads[4])
            else:
                if not _rows_aligned(dy):  # a layout the kernel cannot read
                    dy = dy.contiguous()
                grads = wkv6_bwd_kernel(r, k, v, w, u, dy)
        return (*grads, None)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, *, plain: bool = False
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable WKV6 from a zero state in the model layout: r, k, w
    ``[B, T, H, K]``, v ``[B, T, H, V]``, u ``[H, K]`` -> (y ``[B, T, H,
    V]`` float32, final state ``[B, H, K, V]`` float32).  The kernels read
    the model layout in place; the plain version takes the ``[B*H, T, K]``
    rows of ``repro.kernels.wkv6.ops.wkv6``."""
    if r.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no wkv6 path for device {r.device}")
    return WKV6.apply(r, k, v, w, u, bool(plain))
