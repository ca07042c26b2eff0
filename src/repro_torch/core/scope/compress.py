"""Hierarchical on-line compression of captured tensors (MegaScope §6.1),
counterpart of ``repro.core.scope.compress``.

Each compressor is a reduction on the tensor's own device: it returns 0-dim
or small tensors and reads nothing back to the host, so only the compressed
form ever travels, once a step, whatever the model's size.  The collector
calls them under ``torch.no_grad`` on a detached value.
"""

from __future__ import annotations

import torch


def _first_at_or_above(v: float, dtype: torch.dtype) -> float:
    """The least value of ``dtype`` at or above float32 ``v``: for ``x`` of
    that dtype, ``x < it`` in ``dtype`` is ``x < v`` in float32."""
    t = torch.tensor(v, dtype=torch.float32)
    c = t.to(dtype)
    if c.float() < t:
        c = torch.nextafter(c, torch.tensor(float("inf"), dtype=dtype))
    return c.item()


def stats_of(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """JAX's float32 statistics, read from ``x`` as it is: on the card each
    reduction loads a bf16 ``x`` and accumulates in float32 in one kernel,
    and the sparsity mask is one buffer of ``x``'s dtype, so no float32
    copy of the activation is made (the CPU's all-reduce ``std`` takes
    float32 only, so there it reads a copy)."""
    n = x.numel()
    std = torch.empty((), dtype=torch.float32, device=x.device)
    torch.std(x if x.is_cuda else x.float(), correction=0, out=std)
    mn, mx = torch.aminmax(x)
    small = x.abs()
    torch.lt(small, _first_at_or_above(1e-6, x.dtype), out=small)  # 1 where |x| < 1e-6
    return {"mean": x.mean(dtype=torch.float32), "std": std,
            "min": mn.float(), "max": mx.float(),
            "l2": torch.linalg.vector_norm(x, dtype=torch.float32),
            "sparsity": small.sum(dtype=torch.float32) / n}


def _linspace(lo: float, hi: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(lo, hi, num)`` in float32, by its formula (``lo * (1 -
    t) + hi * t`` at ``t = i / (num - 1)``, then ``hi``), so edges, and so
    histogram counts, are the same bits as the JAX package's."""
    div = num - 1
    t = torch.arange(div, dtype=torch.float32, device=device) / div
    lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=device)
    return torch.cat([lo_t * (1 - t) + hi_t * t, hi_t[None]])


def histogram(x: torch.Tensor, bins: int = 32, lo: float = -8.0,
              hi: float = 8.0) -> dict[str, torch.Tensor]:
    xf = x.float().reshape(-1)
    edges = _linspace(lo, hi, bins + 1, x.device)
    # jnp.searchsorted's default side is "left": right=False
    idx = torch.clamp(torch.searchsorted(edges, xf) - 1, 0, bins - 1)
    counts = torch.bincount(idx, minlength=bins).to(torch.int32)
    return {"hist": counts, "edges": edges}


def subsample(x: torch.Tensor, k: int = 64) -> torch.Tensor:
    """Strided slice of the trailing dim (cheap deterministic sketch); a
    copy, so the capture does not keep the whole activation alive."""
    flat = x.reshape(-1, x.shape[-1])
    r_stride = max(flat.shape[0] // k, 1)
    c_stride = max(x.shape[-1] // k, 1)
    return flat[::r_stride][:k, ::c_stride][:, :k].clone()


def channel_profile(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-channel mean/max over all other dims (distribution-drift view)."""
    xf = x.float()
    red = tuple(range(xf.dim() - 1))
    return {"ch_mean": xf.mean(red), "ch_absmax": xf.abs().amax(red)}


def full(x: torch.Tensor) -> torch.Tensor:
    return x


COMPRESSORS = {
    "stats": stats_of,
    "hist": histogram,
    "sample": subsample,
    "channels": channel_profile,
    "full": full,
}
