"""RMSNorm dispatch (K1): the Triton forward (``rmsnorm_triton.py``) and the
CUDA backward (``csrc/rmsnorm_bwd.cu``) for tensors on the card, the plain
versions (``ref.py``) for tensors on the CPU.

The device of the tensors decides, and ``plain=True`` (the card's reference
runs) nothing else: a CUDA tensor launches its kernel or raises (wrong dtype,
shape or layout, a failed build or launch); it never falls back to the plain
version.  A tensor on the ``meta`` device (the dryrun) passes the same checks
and gets what the kernel would return, allocated as the wrapper allocates it,
with nothing launched; the backward's meta branch notes ``rmsnorm_bwd`` in
``_build.meta_calls``.  Each kernel wrapper adds one to ``launches[name]``
where it launches its kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain

launches = {"rmsnorm_fwd": 0, "rmsnorm_bwd": 0}

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_D = 16384
# the backward's geometry (csrc/rmsnorm_bwd.cu): rows cut into chunks of 8
# elements, at most 4 chunks a thread and 512 threads a CTA, the staged
# rows within this much shared memory; the dryrun's grid on the meta device
# is an H100's 132 SMs
_CHUNK, _MAX_K, _THREADS = 8, 4, 512
_STAGE_BYTES = 220 * 1024
_META_CTAS = 132

_P, _I = ctypes.c_void_p, ctypes.c_int
_functions: dict[str, ctypes._CFuncPtr] = {}
_resident: dict[tuple, int] = {}   # (device, plan) -> CTAs the device holds


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _tiling(D: int) -> tuple[int, int, int]:
    """The forward's (BLOCK_D, ROWS, num_warps): the row in one power-of-two
    block, about 4096 float32 values per program."""
    block_d = 1 << max(D - 1, 1).bit_length()
    rows = max(1, min(64, 4096 // block_d))
    return block_d, rows, 8 if block_d >= 2048 else 4


def _plan(D: int, x_f32: bool, vec: bool) -> tuple[int, int, int, int, int]:
    """The backward's ``(G, K, R, stages, smem)`` for rows of ``D``: G
    threads a row (a power of two up to 32, a multiple of 32 above), K
    chunks of 8 elements a thread, the K that wastes the fewest chunk slots
    (the larger K on a tie); R rows a CTA at once (at most 512 threads, fewer
    where two stages of them would not fit); ``stages`` slots of staged
    rows (1 to 3: a fourth was slower at 3584 and no faster elsewhere on
    the H100; none on the scalar path); ``smem`` dynamic bytes, enough
    for the stages and the scale (``D`` float32 at most) and for the CTA's
    ``[R, K * 8 * G]`` float32 dscale fold."""
    chunks = -(-D // _CHUNK)
    best = None
    for K in range(_MAX_K, 0, -1):
        g = -(-chunks // K)
        G = 1 << (g - 1).bit_length() if g <= 32 else -(-g // 32) * 32
        if G <= _THREADS and (best is None or G * K - chunks < best[0]):
            best = (G * K - chunks, G, K)
    _, G, K = best
    R = max(1, _THREADS // G)
    fold = R * G * K * _CHUNK * 4
    if not vec:
        return G, K, R, 1, fold
    # a thread's x and dy chunks and its row's rstd, a stage
    per_row = G * (2 * K * _CHUNK * (4 if x_f32 else 2) + 4)
    budget = _STAGE_BYTES - 4 * D
    while R > 1 and budget // (R * per_row) < 2:
        R //= 2
    stages = max(1, min(3, budget // (R * per_row)))
    return G, K, R, stages, max(stages * R * per_row + 4 * D, fold)


def shared_memory_bytes(D: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The backward's dynamic shared memory a CTA at width ``D``."""
    return _plan(D, dtype == torch.float32, D % _CHUNK == 0)[4]


def _kernel(name: str, argtypes: list, restype=ctypes.c_int):
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(_build.load("rmsnorm_bwd"), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _functions[name] = fn
    return fn


def _max_ctas(device: torch.device, x_f32: bool, K: int, vec: bool, threads: int,
              smem: int) -> int:
    """CTAs of this plan the card holds at once: the grid's ceiling (every
    CTA resident, so the kernel's grid barrier cannot wait on one)."""
    key = (device.index, x_f32, K, vec, threads, smem)
    n = _resident.get(key)
    if n is None:
        with torch.cuda.device(device):
            n = _kernel("rmsnorm_bwd_max_ctas", [_I] * 5, ctypes.c_longlong)(
                int(x_f32), K, int(vec), threads, smem)
        if n <= 0:
            raise RuntimeError(f"rmsnorm_bwd: no CTA of {threads} threads and {smem} "
                               f"bytes fits an SM (CUDA error {-n})")
        _resident[key] = n
    return n


def _check(x: torch.Tensor, scale: torch.Tensor, what: str = "x") -> int:
    if x.device.type not in ("cuda", "meta") or scale.device != x.device:
        raise ValueError(f"{what} and scale must be on one CUDA device, got "
                         f"{x.device} and {scale.device}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes bfloat16 or float32, got {what} "
                        f"{x.dtype} and scale {scale.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{what} must be [rows, D], got {tuple(x.shape)}")
    D = x.shape[1]
    if tuple(scale.shape) != (D,) or not 0 < D <= _MAX_D:
        raise ValueError(f"scale {tuple(scale.shape)} does not match D={D} "
                         f"(1..{_MAX_D})")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{what} and scale must be contiguous")
    return D


def rmsnorm_fwd_kernel(x: torch.Tensor, scale: torch.Tensor, eps: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward: x ``[rows, D]``, scale ``[D]`` -> (y in x's dtype,
    rstd ``[rows]`` float32)."""
    from repro_torch.kernels.rmsnorm.rmsnorm_triton import kernels

    D = _check(x, scale)
    n = x.shape[0]
    y = torch.empty_like(x)
    rstd = torch.empty((n,), dtype=torch.float32, device=x.device)
    if x.is_meta:
        return y, rstd
    block_d, rows, warps = _tiling(D)
    kernels()[(max(1, -(-n // rows)),)](x, scale, y, rstd, n, D, float(eps),
                                        ROWS=rows, BLOCK_D=block_d, num_warps=warps)
    launches["rmsnorm_fwd"] += 1
    return y, rstd


def rmsnorm_bwd_kernel(x: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor,
                       dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward: -> (dx in x's dtype, dscale in scale's dtype)."""
    D = _check(x, scale)
    _check(dy, scale, "dy")
    n = x.shape[0]
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if (rstd.dtype != torch.float32 or tuple(rstd.shape) != (n,)
            or rstd.device != x.device or not rstd.is_contiguous()):
        raise ValueError("rstd must be float32 [rows] on x's device")
    x_f32 = x.dtype == torch.float32
    vec = D % _CHUNK == 0 and (x.is_meta or all(
        t.data_ptr() % 16 == 0 for t in (x, dy, scale)))
    G, K, R, stages, smem = _plan(D, x_f32, vec)
    dx = torch.empty_like(x)
    dscale = torch.empty((D,), dtype=scale.dtype, device=x.device)
    if x.is_meta:
        ws = torch.empty((max(1, min(_META_CTAS, -(-n // R))), G * K * _CHUNK),
                         dtype=torch.float32, device=x.device)
        del ws  # freed when the call returns, as on the card
        _build.meta_calls.add("rmsnorm_bwd")
        return dx, dscale
    n_cta = max(1, min(_max_ctas(x.device, x_f32, K, vec, G * R, smem), -(-n // R)))
    ws = torch.empty((n_cta, G * K * _CHUNK), dtype=torch.float32, device=x.device)
    err = _kernel("rmsnorm_bwd", [_P] * 7 + [_I] * 11 + [_P])(
        x.data_ptr(), dy.data_ptr(), scale.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        dscale.data_ptr(), ws.data_ptr(), n, D, int(x_f32),
        int(scale.dtype == torch.float32), K, int(vec), G, R, stages, smem, n_cta,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm_bwd launch failed: CUDA error {err}")
    launches["rmsnorm_bwd"] += 1
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, scale, eps):
        y, rstd = rmsnorm_fwd_kernel(x2, scale, eps)
        ctx.save_for_backward(x2, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, scale, rstd = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_kernel(x2, scale, rstd, dy.contiguous())
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
            plain: bool = False) -> torch.Tensor:
    """``y = x * rsqrt(mean(x^2, -1) + eps) * scale`` over the last dim of
    ``x [..., D]``, float32 inside, x's dtype out; differentiable in both."""
    if plain or x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no rmsnorm path for device {x.device}")
    D = x.shape[-1]
    y = _RMSNorm.apply(x.contiguous().view(-1, D), scale.contiguous(), float(eps))
    return y.view(x.shape)
