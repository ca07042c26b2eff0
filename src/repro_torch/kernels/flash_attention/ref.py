"""Plain PyTorch versions of the flash-attention kernels (K2).

``flash_fwd_plain`` computes what ``repro.kernels.flash_attention.kernel.
flash_attention_pallas`` and ``repro.models.layers._flash_forward`` compute
for a non-paged attention: GQA scores in float32 (kv head ``h // G``), query
row ``i`` at position ``i``, keys ``t < T``, the causal / window masks,
``NEG = -1e30`` for masked scores, probabilities rounded to the value dtype
before the PV product, float32 sums, the ``l == 0`` guard, plus the float32
log-sum-exp ``lse [B*H, S]``.  It takes the whole row at once where the
reference walks kv chunks; the two differ only in float32 rounding.

``flash_bwd_plain`` is the bwd of ``repro.models.layers._make_flash`` with
its roundings of ``p``, ``dO`` and ``ds`` to the key dtype, dk and dv summed
over the G query heads of each kv head.  It takes ``delta`` (the row sums of
dO * O over v's head dim) from the output it is given (the kernel's, in the
model dtype).

v's head dim ``Dv`` may differ from q's and k's ``D`` (MLA), as in the
Pallas kernel and ``_make_flash``: o, dO and dv have ``Dv`` columns.

These run on whatever device their inputs live on: the CPU tests hold them
against the JAX package; ``chip_smoke.py`` holds the CUDA kernels to them.
"""

from __future__ import annotations

import torch

NEG = -1e30


def visible(S: int, T: int, causal: bool, window: int | None,
            device: torch.device) -> torch.Tensor:
    """``[S, T]`` bool, True where query row i attends key t."""
    row = torch.arange(S, device=device)[:, None]
    col = torch.arange(T, device=device)[None, :]
    m = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        m &= col <= row
    if window is not None:
        m &= col > row - window
    return m


def _grouped(q, k, v):
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    if v.shape[:3] != k.shape[:3]:
        raise ValueError(f"v {tuple(v.shape)} does not match k {tuple(k.shape)} "
                         "but in its head dim")
    return B, S, H, D, T, K, H // K, v.shape[3]


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """q ``[B, S, H, D]``, k ``[B, T, K, D]``, v ``[B, T, K, Dv]`` -> (o
    ``[B, S, H, Dv]`` in q's dtype, lse ``[B*H, S]`` float32)."""
    B, S, H, D, T, K, G, Dv = _grouped(q, k, v)
    qg = q.reshape(B, S, K, G, D).float()
    s = torch.einsum("bskgd,btkd->bskgt", qg, k.float()) * scale
    m = visible(S, T, causal, window, q.device)[None, :, None, None, :]
    s = torch.where(m, s, NEG)
    mx = s.amax(-1)
    p = torch.where(m, torch.exp(s - mx[..., None]), 0.0)
    l = p.sum(-1)
    o = torch.einsum("bskgt,btkd->bskgd", p.to(v.dtype).float(), v.float())
    o = o / torch.where(l == 0, 1.0, l)[..., None]
    lse = torch.where(l == 0, 0.0, mx + torch.log(torch.clamp(l, min=1e-30)))
    lse = lse.reshape(B, S, H).permute(0, 2, 1).reshape(B * H, S)
    return o.reshape(B, S, H, Dv).to(q.dtype), lse.contiguous()


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the dtypes of q, k, v; o and dO are ``[B, S, H,
    Dv]``."""
    B, S, H, D, T, K, G, Dv = _grouped(q, k, v)
    for what, t in (("o", o), ("do", do)):
        if tuple(t.shape) != (B, S, H, Dv):
            raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                             f"{(B, S, H, Dv)}")
    kd = k.dtype
    qg = q.reshape(B, S, K, G, D).float()
    kf, vf = k.float(), v.float()
    do_f = do.reshape(B, S, K, G, Dv).float()
    delta = (do_f * o.reshape(B, S, K, G, Dv).float()).sum(-1)
    lse_g = lse.reshape(B, H, S).permute(0, 2, 1).reshape(B, S, K, G)
    s = torch.einsum("bskgd,btkd->bskgt", qg, kf) * scale
    m = visible(S, T, causal, window, q.device)[None, :, None, None, :]
    p = torch.where(m, torch.exp(s - lse_g[..., None]), 0.0)
    p_b = p.to(kd).float()
    do_b = do_f.to(kd).float()
    dv = torch.einsum("bskgt,bskgd->btkd", p_b, do_b)
    dp = torch.einsum("bskgd,btkd->bskgt", do_b, vf)
    ds = p * (dp - delta[..., None]) * scale
    ds_b = ds.to(kd).float()
    dq = torch.einsum("bskgt,btkd->bskgd", ds_b, kf)
    dk = torch.einsum("bskgt,bskgd->btkd", ds_b, qg)
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(kd), dv.to(v.dtype))
