"""Paged-attention dispatch: the CUDA kernels for tensors on the card, the
plain versions (``ref.py``) for tensors on the CPU.

The device of the tensors decides, and nothing else: a CUDA tensor always
launches its kernel or raises (wrong dtype, layout or shape, failed build or
launch); it never falls back to the plain version.  A tensor on the ``meta``
device (the dryrun) passes the same checks and gets what the kernel would
return, allocated as the wrapper allocates it (K3's split scratch
included), with nothing launched.  Each kernel wrapper adds one to
``launches[name]`` where it launches its kernel, so a run can show that the
main path went through the kernels.

``PagedInfo`` is the small descriptor the serving engine threads through
``lm.forward`` down to ``layers.gqa_apply`` to put an attention block onto
the paged pool: the block's cache is then the layer-stacked pool
``[n_layers, num_blocks, bs, K, dh]`` and attention walks ``tables``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_plain,
    paged_prefill_plain_from_raw,
)

launches = {"paged_decode": 0, "paged_prefill": 0}

# head dims each kernel is instantiated for: K3 also at recurrentgemma-9b's
# 256; K4 at 256 lies on no path of the JAX package (a Griffin prompt goes
# through the dense cache's segment prefill) and stays to be ported
HEAD_DIMS = {"paged_decode": (16, 32, 64, 128, 256),
             "paged_prefill": (16, 32, 64, 128)}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, k_pool, v_pool, tables, kv_len, scratch, out, S, Q, H, K, dh, bs, M,
    # NB, layer offset, scale, window, q_f32, stream
    "paged_decode": [_P] * 7 + [_I] * 8
    + [ctypes.c_longlong, ctypes.c_float, _I, _I, _P],
    # q, q_norm, k_pool, v_pool, tables, kv_len, out, S, Q, H, K, dh, bs, M,
    # NB, layer offset, scale, window, eps, rope_theta, stream
    "paged_prefill": [_P] * 7 + [_I] * 8
    + [ctypes.c_longlong, ctypes.c_float, _I, ctypes.c_float, ctypes.c_float, _P],
}
_functions: dict[str, ctypes._CFuncPtr] = {}
_smem_limits: dict[int | None, int] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@dataclass(frozen=True)
class PagedInfo:
    """Paged-KV view descriptor: the per-slot block tables (possibly sliced
    to the live-block high-water mark) plus the pool geometry.

    ``layer`` indexes the layer-stacked pools.  ``prefill=True`` puts
    attention blocks with more than one query onto the fused flash-prefill
    path (K norm + rope + scatter, then attention against the pool);
    ``q_start`` is the absolute position of query 0 when it is the same for
    every slot (a full prefill pins 0), which bands the plain version.
    ``plain=True`` makes the model call the plain versions whatever the
    device: the teacher-forced reference on the card.
    """

    tables: torch.Tensor    # [S, M] int32, padding entries -> null block 0
    block_size: int
    layer: int | None = None
    prefill: bool = False
    q_start: int | None = None
    plain: bool = False


def _kernel(name: str):
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(_build.load(name), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def _c_size(name: str, symbol: str, n_ints: int):
    """The ``size_t symbol(int, ...)`` export of kernel ``name``'s library."""
    fn = _functions.get(symbol)
    if fn is None:
        fn = getattr(_build.load(name), symbol)
        fn.argtypes, fn.restype = [_I] * n_ints, ctypes.c_size_t
        _functions[symbol] = fn
    return fn


def meta_scratch_bytes(S: int, Q: int, H: int, K: int, dh: int, bs: int,
                       M: int) -> int:
    """``paged_decode_scratch_bytes`` without the library, for the meta
    device: a float32 partial (dh values, the max and the sum) of each
    query row of every 128-position split of each slot and kv head."""
    splits = -(-(M * bs) // 128)
    return 4 * S * K * splits * Q * (H // K) * (dh + 2)


def shared_memory_bytes(name: str, *, H: int, K: int, dh: int, Q: int = 1) -> int:
    """Dynamic shared memory one block of kernel ``name`` takes (ptxas
    reports static shared memory only): a decode split block holds the
    ``Q`` queries of a kv head beside its K/V rows, a prefill block a tile
    of 64 queries beside its K/V rings (H, K and Q do not enter)."""
    if name == "paged_prefill":
        return _c_size(name, "paged_prefill_smem_bytes", 1)(dh)
    return _c_size(name, "paged_decode_smem_bytes", 4)(Q, H, K, dh)


def shared_memory_limit(device: torch.device) -> int:
    """The dynamic shared memory a block may opt into on ``device``
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``), read once a device."""
    if device.index not in _smem_limits:
        fn = _build.load("paged_decode").paged_decode_smem_limit
        fn.argtypes, fn.restype = [], ctypes.c_longlong
        with torch.cuda.device(device):
            limit = fn()
        if limit < 0:
            raise RuntimeError(
                f"reading the shared memory limit failed: CUDA error {-limit}")
        _smem_limits[device.index] = limit
    return _smem_limits[device.index]


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


def _pool_geometry(name, q, k_pool, v_pool, tables, kv_len, layer):
    """Checks kernel ``name``'s common operands; returns (S, Q, H, K, dh,
    bs, M, NB, layer element offset)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [S, Q, H, dh], got {tuple(q.shape)}")
    S, Q, H, dh = q.shape
    if k_pool.dim() == 4:
        n, layer = 1, 0
        NB, bs, K, _ = k_pool.shape
    elif k_pool.dim() == 5:
        n, NB, bs, K, _ = k_pool.shape
        if layer is None or not 0 <= layer < n:
            raise ValueError(f"layer {layer} outside the stacked pool's {n}")
    else:
        raise ValueError(f"pools must be 4-D or 5-D, got {tuple(k_pool.shape)}")
    if H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    if dh not in HEAD_DIMS[name]:
        gap = (" (K4 at head dim 256: ROADMAP queue 2, on no JAX path)"
               if name == "paged_prefill" and dh == 256 else "")
        raise ValueError(f"head dim {dh}: {name} takes {HEAD_DIMS[name]}{gap}")
    M = tables.shape[1] if tables.dim() == 2 else -1
    dev, bf16 = q.device, torch.bfloat16
    # K3 also takes a float32 model's queries (its pool stays bfloat16)
    f32_q = name == "paged_decode" and q.dtype == torch.float32
    _require(q, "q", torch.float32 if f32_q else bf16, (S, Q, H, dh), dev)
    _require(k_pool, "k_pool", bf16, tuple(k_pool.shape[:-1]) + (dh,), dev)
    _require(v_pool, "v_pool", bf16, tuple(k_pool.shape), dev)
    _require(tables, "tables", torch.int32, (S, M), dev)
    _require(kv_len, "kv_len", torch.int32, (S,), dev)
    for t, what in ((q, "q"), (k_pool, "k_pool"), (v_pool, "v_pool")):
        if t.data_ptr() % 16:
            raise ValueError(f"{what} must start 16-byte aligned (16-byte copies)")
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on the card; the operands are on {dev}")
    return S, Q, H, K, dh, bs, M, NB, layer * NB * bs * K * dh


def paged_decode_kernel(
    q: torch.Tensor,        # [S, Q, H, dh] bf16 (or float32) on the card
    k_pool: torch.Tensor,   # [(n,) NB, bs, K, dh] bf16
    v_pool: torch.Tensor,
    tables: torch.Tensor,   # [S, M] int32
    kv_len: torch.Tensor,   # [S] int32
    *,
    scale: float,
    window: int | None = None,
    layer: int | None = None,
) -> torch.Tensor:
    """Launch the paged decode kernel (``csrc/paged_decode.cu``): a split
    kernel over the table walk and the combine of its float32 partials,
    which live in a scratch buffer allocated here on the same stream.  The
    output takes q's dtype."""
    S, Q, H, K, dh, bs, M, NB, off = _pool_geometry(
        "paged_decode", q, k_pool, v_pool, tables, kv_len, layer)
    if q.is_meta:
        _build.meta_calls.add("paged_decode")
        out = torch.empty_like(q)
        scratch = torch.empty(meta_scratch_bytes(S, Q, H, K, dh, bs, M) // 4,
                              dtype=torch.float32, device=q.device)
        del scratch  # freed when the call returns, as on the card
        return out
    smem = shared_memory_bytes("paged_decode", H=H, K=K, dh=dh, Q=Q)
    limit = shared_memory_limit(q.device)
    if smem > limit:
        raise ValueError(
            f"paged_decode at Q={Q}, H={H}, K={K}, dh={dh} needs {smem} bytes "
            f"of shared memory a block; the device allows {limit}")
    out = torch.empty_like(q)
    nbytes = _c_size("paged_decode", "paged_decode_scratch_bytes", 7)(
        S, Q, H, K, dh, bs, M)
    scratch = torch.empty(nbytes // 4, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel("paged_decode")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        kv_len.data_ptr(), scratch.data_ptr(), out.data_ptr(), S, Q, H, K, dh,
        bs, M, NB, off, float(scale), -1 if window is None else int(window),
        int(q.dtype == torch.float32), stream,
    )
    if err:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {err}")
    launches["paged_decode"] += 1
    return out


def paged_prefill_kernel(
    q: torch.Tensor,        # [S, Q, H, dh] raw (pre-norm, pre-rope) bf16
    k_pool: torch.Tensor,   # [(n,) NB, bs, K, dh] bf16, new K/V written
    v_pool: torch.Tensor,
    tables: torch.Tensor,   # [S, M] int32
    kv_len: torch.Tensor,   # [S] int32
    *,
    scale: float,
    window: int | None = None,
    layer: int | None = None,
    q_norm: torch.Tensor | None = None,  # [dh] float32 qk_norm scale
    eps: float = 1e-6,
    rope_theta: float = 10000.0,
) -> torch.Tensor:
    """Launch the flash-prefill kernel (``csrc/paged_prefill.cu``)."""
    S, Q, H, K, dh, bs, M, NB, off = _pool_geometry(
        "paged_prefill", q, k_pool, v_pool, tables, kv_len, layer)
    qn_ptr = None
    if q_norm is not None:
        _require(q_norm, "q_norm", torch.float32, (dh,), q.device)
        qn_ptr = q_norm.data_ptr()
    out = torch.empty_like(q)
    if q.is_meta:
        _build.meta_calls.add("paged_prefill")
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel("paged_prefill")(
        q.data_ptr(), qn_ptr, k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        S, Q, H, K, dh, bs, M, NB, off, float(scale),
        -1 if window is None else int(window), float(eps), float(rope_theta),
        stream,
    )
    if err:
        raise RuntimeError(f"paged_prefill launch failed: CUDA error {err}")
    launches["paged_prefill"] += 1
    return out


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no paged-attention path for device {t.device}")
    return t.device.type


def paged_attention(
    q: torch.Tensor,        # [S, Q, H, dh] or [S, H, dh]
    k_pool: torch.Tensor,   # [(n_layers,) num_blocks, bs, K, dh]
    v_pool: torch.Tensor,   # [(n_layers,) num_blocks, bs, K, dv]
    *,
    tables: torch.Tensor,   # [S, M] int32
    kv_len: torch.Tensor,   # [S] int32 (live positions incl. all Q new tokens)
    scale: float,
    window: int | None = None,
    layer: int | None = None,  # required for layer-stacked (5-D) pools
) -> torch.Tensor:
    """Decode/verify attention straight against the pool."""
    if _device_kind(q) == "cpu":
        return paged_attention_plain(
            q, k_pool, v_pool, tables, kv_len, scale=scale, window=window,
            layer=layer,
        )
    squeeze = q.dim() == 3
    o = paged_decode_kernel(
        q[:, None] if squeeze else q, k_pool, v_pool, tables, kv_len,
        scale=scale, window=window, layer=layer,
    )
    return o[:, 0] if squeeze else o


def scatter_kv(
    k_new: torch.Tensor,    # [S, Q, K, dh] keys, normed and roped
    vv: torch.Tensor,       # [S, Q, K, dv] values
    k_pool: torch.Tensor,   # [(n_layers,) num_blocks, bs, K, dh], updated in place
    v_pool: torch.Tensor,
    *,
    tables: torch.Tensor,   # [S, M] int32
    positions: torch.Tensor,  # [S, Q] int write positions per slot
    block_size: int,
    layer: int | None = None,
) -> torch.Tensor:
    """The bfloat16 quantization of the new K/V and their scatter into the
    blocks owning each slot's write positions, in place (the JAX package
    donates the pools).  Write positions beyond the table's reach go to the
    null block 0, like inactive slots' writes at position 0; duplicate
    writes there are harmless because every read masks them.  Returns
    ``kv_len`` ``[S]`` int32 (the last write position + 1)."""
    pos = positions.long()
    bs = block_size
    in_reach = pos < tables.shape[1] * bs
    blk = torch.where(in_reach, pos // bs, 0)
    phys = torch.gather(tables.long(), 1, blk)
    phys = torch.where(in_reach, phys, 0)
    off = pos % bs
    k_new = k_new.to(torch.bfloat16).to(k_pool.dtype)
    v_new = vv.to(torch.bfloat16).to(v_pool.dtype)
    if layer is None:
        k_pool[phys, off] = k_new
        v_pool[phys, off] = v_new
    else:
        k_pool[layer, phys, off] = k_new
        v_pool[layer, phys, off] = v_new
    return (pos[:, -1] + 1).to(torch.int32)


def write_kv(
    kk: torch.Tensor,       # [S, Q, K, dh] raw post-projection keys
    vv: torch.Tensor,       # [S, Q, K, dv] values
    k_pool: torch.Tensor,   # [(n_layers,) num_blocks, bs, K, dh], updated in place
    v_pool: torch.Tensor,
    *,
    tables: torch.Tensor,   # [S, M] int32
    positions: torch.Tensor,  # [S, Q] int write positions per slot
    block_size: int,
    layer: int | None = None,
    k_norm: torch.Tensor | None = None,
    eps: float = 1e-6,
    rope_theta: float = 10000.0,
    plain: bool = False,
) -> torch.Tensor:
    """The K-side entry into the pool: optional qk_norm on K (``plain``
    selects the plain norm), rope, then :func:`scatter_kv`.  Returns
    ``kv_len`` ``[S]`` int32."""
    # layers imports this module, so its helpers load on first call
    from repro_torch.models.layers import apply_rope, rms_head_norm

    if k_norm is not None:
        kk = rms_head_norm(k_norm, kk, eps, plain=plain)
    kk = apply_rope(kk, positions, rope_theta)
    return scatter_kv(kk, vv, k_pool, v_pool, tables=tables,
                      positions=positions, block_size=block_size, layer=layer)


def paged_prefill(
    q: torch.Tensor,        # [S, Q, H, dh] raw post-projection queries
    kk: torch.Tensor,       # [S, Q, K, dh] raw post-projection keys
    vv: torch.Tensor,       # [S, Q, K, dv] values
    k_pool: torch.Tensor,   # [(n_layers,) num_blocks, bs, K, dh], updated in place
    v_pool: torch.Tensor,
    *,
    tables: torch.Tensor,   # [S, M] int32
    positions: torch.Tensor,  # [S, Q] int contiguous write positions per slot
    block_size: int,
    scale: float,
    window: int | None = None,
    layer: int | None = None,
    q_norm: torch.Tensor | None = None,  # [dh] qk_norm scales (None = off)
    k_norm: torch.Tensor | None = None,
    eps: float = 1e-6,
    rope_theta: float = 10000.0,
    q_start: int | None = None,
    q_block: int = 32,
) -> torch.Tensor:
    """Fused paged prefill: write the new K/V into the pool (:func:`write_kv`),
    then flash-attend the Q query rows against the pool through the block
    table.  On the card the q-side qk_norm and rope run inside the kernel's
    prologue; on the CPU they run here before the plain banded version.
    Returns the attention output ``[S, Q, H, dv]``."""
    kv_len = write_kv(
        kk, vv, k_pool, v_pool, tables=tables, positions=positions,
        block_size=block_size, layer=layer, k_norm=k_norm, eps=eps,
        rope_theta=rope_theta,
    )
    if _device_kind(q) != "cpu":
        return paged_prefill_kernel(
            q.contiguous(), k_pool, v_pool, tables, kv_len, scale=scale,
            window=window, layer=layer, q_norm=q_norm, eps=eps,
            rope_theta=rope_theta,
        )
    return paged_prefill_plain_from_raw(
        q, k_pool, v_pool, tables, kv_len, positions=positions, scale=scale,
        window=window, layer=layer, q_norm=q_norm, eps=eps,
        rope_theta=rope_theta, q_start=q_start, q_block=q_block,
    )

