"""RMSNorm dispatch: the Triton kernels (``rmsnorm_triton.py``) for tensors
on the card, the plain versions (``ref.py``) for tensors on the CPU.

The device of the tensors decides, and ``plain=True`` (the card's reference
runs) nothing else: a CUDA tensor launches its kernel or raises (wrong dtype,
shape or layout); it never falls back to the plain version.  A tensor on the
``meta`` device (the dryrun) passes the same checks and gets what the kernel
would return, allocated as the wrapper allocates it, with nothing launched.
Each kernel wrapper adds one to ``launches[name]`` where it launches its
kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain

launches = {"rmsnorm_fwd": 0, "rmsnorm_bwd": 0}

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_D = 16384
# the backward's programs: each walks row blocks with this stride and keeps
# one float32 partial dscale row, summed by the wrapper in a fixed order
_BWD_PROGRAMS = 528  # 4 x 132 SMs


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _tiling(D: int) -> tuple[int, int, int]:
    """(BLOCK_D, ROWS, num_warps): the row in one power-of-two block, about
    4096 float32 values per program."""
    block_d = 1 << max(D - 1, 1).bit_length()
    rows = max(1, min(64, 4096 // block_d))
    return block_d, rows, 8 if block_d >= 2048 else 4


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
    fwd, _ = kernels()
    fwd[(max(1, -(-n // rows)),)](x, scale, y, rstd, n, D, float(eps),
                                  ROWS=rows, BLOCK_D=block_d, num_warps=warps)
    launches["rmsnorm_fwd"] += 1
    return y, rstd


def rmsnorm_bwd_kernel(x: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor,
                       dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward: -> (dx in x's dtype, dscale in scale's dtype)."""
    from repro_torch.kernels.rmsnorm.rmsnorm_triton import kernels

    D = _check(x, scale)
    _check(dy, scale, "dy")
    n = x.shape[0]
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if (rstd.dtype != torch.float32 or tuple(rstd.shape) != (n,)
            or rstd.device != x.device or not rstd.is_contiguous()):
        raise ValueError("rstd must be float32 [rows] on x's device")
    block_d, rows, warps = _tiling(D)
    n_prog = max(1, min(_BWD_PROGRAMS, -(-n // rows)))
    dx = torch.empty_like(x)
    part = torch.empty((n_prog, D), dtype=torch.float32, device=x.device)
    if x.is_meta:
        return dx, part.sum(0).to(scale.dtype)
    _, bwd = kernels()
    bwd[(n_prog,)](x, scale, dy, rstd, dx, part, n, D,
                   ROWS=rows, BLOCK_D=block_d, num_warps=warps)
    launches["rmsnorm_bwd"] += 1
    return dx, part.sum(0).to(scale.dtype)


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
