"""RMSNorm forward for Hopper, in Triton (K1).

Replaces ``repro/kernels/rmsnorm/kernel.py:rmsnorm_pallas``, the Pallas TPU
kernel that fuses the mean-square reduction, the normalisation and the scale
into one pass over ``block_rows`` rows at a time.  The backward is CUDA C++
(``csrc/rmsnorm_bwd.cu``).

What bounds it on the H100: bytes.  The forward reads x and writes y once
(4 bytes a bf16 element, a handful of flops); a [16384, 896] bf16 forward
moves 58.7 MB, 0.018 ms at 3.35 TB/s.

Design: one program per ``ROWS`` rows with the model dim in one power-of-two
block (masked), float32 inside, the row's ``rstd`` written for the backward
(4 bytes a row).

``triton`` is imported inside :func:`kernels`, at the first launch: importing
this module needs no Triton.  Unless ``TRITON_CACHE_DIR`` is set, Triton's
compile cache goes to ``build/triton/`` beside the CUDA libraries
(``kernels/_build.py``), inside the checkout; with a compile cache attached
(``_build.use_cache``) it goes under that cache (``CompileCache.triton_dir``),
so a warm process loads K1's binaries instead of compiling them.
"""

from __future__ import annotations

import os

_KERNELS = None
_POINTED: list = []   # the compile cache TRITON_CACHE_DIR points under


def _point_triton_cache() -> None:
    """Triton reads ``TRITON_CACHE_DIR`` when it compiles a specialisation:
    point it under the attached compile cache, else (unless the caller set
    it) at ``build/triton``; once a cache, not at every launch."""
    from repro_torch.kernels import _build

    cache = _build.attached()
    if _POINTED and _POINTED[0] is cache:
        return
    _POINTED[:] = [cache]
    if cache is not None:
        os.environ["TRITON_CACHE_DIR"] = str(cache.triton_dir())
    else:
        os.environ.setdefault("TRITON_CACHE_DIR",
                              str(_build.BUILD_DIR.parent / "triton"))


def kernels():
    """The jitted Triton forward, built on first use."""
    global _KERNELS
    _point_triton_cache()
    if _KERNELS is not None:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_fwd(X, S, Y, RSTD, n_rows, D, eps,
                    ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        rows = pid * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK_D)
        rmask = rows < n_rows
        cmask = cols < D
        mask = rmask[:, None] & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * D + cols[None, :]
        x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
        rstd = 1.0 / tl.sqrt_rn(tl.sum(x * x, axis=1) / D + eps)
        s = tl.load(S + cols, mask=cmask, other=0.0).to(tl.float32)
        y = x * rstd[:, None] * s[None, :]
        tl.store(Y + offs, y.to(Y.dtype.element_ty), mask=mask)
        tl.store(RSTD + rows, rstd, mask=rmask)

    _KERNELS = rmsnorm_fwd
    return _KERNELS
