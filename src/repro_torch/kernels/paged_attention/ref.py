"""Plain PyTorch versions of the paged-attention kernels.

``paged_attention_plain`` mirrors ``repro.kernels.paged_attention.ref.
paged_attention_ref`` operation for operation: each slot's live blocks are
gathered out of the pool through its block table, K/V are cast to the query
dtype, scores accumulate in float32, masked scores are ``NEG = -1e30``, the
softmax probabilities are cast to the value dtype before the PV product, and
that product accumulates in float32.  ``paged_prefill_plain`` mirrors
``paged_prefill_ref``: the same call over static q-blocks, each scored only
against the table prefix its causal reach can see.

These run on whatever device their inputs live on.  The CPU tests hold them
against the JAX package; ``chip_smoke.py`` holds the CUDA kernels against
them on the card; the model reaches them on the card only when a caller asks
for the plain path explicitly (``PagedInfo.plain``).

Query ``i`` of ``Q`` sits at absolute position ``kv_len - Q + i`` and attends
keys ``< kv_len - (Q - 1 - i)``; the window mask shifts per query the same
way.  At ``Q = 1`` this is the plain decode mask.
"""

from __future__ import annotations

import torch

NEG = -1e30


def paged_attention_plain(
    q: torch.Tensor,        # [S, H, dh] or [S, Q, H, dh]
    k_pool: torch.Tensor,   # [(n,) num_blocks, bs, K, dh]
    v_pool: torch.Tensor,   # [(n,) num_blocks, bs, K, dv]
    tables: torch.Tensor,   # [S, M] int
    kv_len: torch.Tensor,   # [S] int, live positions incl. all Q new tokens
    *,
    scale: float,
    window: int | None = None,
    layer: int | None = None,  # indexes layer-stacked 5-D pools
) -> torch.Tensor:
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    S, Q, H, dh = q.shape
    bs, K, dv = v_pool.shape[-3:]
    M = tables.shape[1]
    G = H // K
    flat = tables.reshape(-1).long()
    if k_pool.dim() == 5:
        k = k_pool[layer, flat]
        v = v_pool[layer, flat]
    else:
        k = k_pool[flat]
        v = v_pool[flat]
    k = k.reshape(S, M * bs, K, dh).to(q.dtype)
    v = v.reshape(S, M * bs, K, dv).to(q.dtype)

    qg = q.reshape(S, Q, K, G, dh)
    s = torch.einsum("bskgd,btkd->bskgt", qg.float(), k.float()) * scale
    dev = q.device
    pos = torch.arange(M * bs, device=dev)[None, None, :]
    limit = kv_len.long()[:, None] - (Q - 1 - torch.arange(Q, device=dev))[None, :]
    mask = pos < limit[:, :, None]                          # [S, Q, T]
    if window is not None:
        mask &= pos > limit[:, :, None] - 1 - window
    s = torch.where(mask[:, :, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bskgt,btkd->bskgd", p.to(v.dtype).float(), v.float())
    o = o.reshape(S, Q, H, dv).to(q.dtype)
    return o[:, 0] if squeeze else o


def paged_prefill_plain(
    q: torch.Tensor,        # [S, Q, H, dh], already normed + roped
    k_pool: torch.Tensor,   # [(n,) num_blocks, bs, K, dh]
    v_pool: torch.Tensor,   # [(n,) num_blocks, bs, K, dv]
    tables: torch.Tensor,   # [S, M] int
    kv_len: torch.Tensor,   # [S] int, live positions incl. all Q new tokens
    *,
    scale: float,
    window: int | None = None,
    layer: int | None = None,
    q_start: int | None = None,  # absolute position of query 0 (all slots)
    q_block: int = 32,
) -> torch.Tensor:
    """Banded q-block version of the flash-prefill kernel.

    With ``q_start`` known, q-block ``iq`` gathers only the
    ``ceil((q_start + (iq+1)*QB) / bs)`` table entries its causal reach can
    see; every excluded key would get an exactly-zero probability, so the
    banding changes the result only through the order of float32 sums.
    """
    S, Q, H, dh = q.shape
    bs = v_pool.shape[-3]
    M = tables.shape[1]
    qb = q_block if (q_block and Q % q_block == 0) else Q
    qb = min(qb, Q)
    outs = []
    for iq in range(Q // qb):
        hi = None if q_start is None else q_start + (iq + 1) * qb
        reach = M if hi is None else max(1, min(M, -(-hi // bs)))
        outs.append(paged_attention_plain(
            q[:, iq * qb:(iq + 1) * qb],
            k_pool, v_pool, tables[:, :reach],
            kv_len - (Q - (iq + 1) * qb),
            scale=scale, window=window, layer=layer,
        ))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def paged_prefill_plain_from_raw(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    tables: torch.Tensor, kv_len: torch.Tensor, *, positions: torch.Tensor,
    scale: float, window: int | None = None, layer: int | None = None,
    q_norm: torch.Tensor | None = None, eps: float = 1e-6,
    rope_theta: float = 10000.0, q_start: int | None = None,
    q_block: int = 32,
) -> torch.Tensor:
    """The plain version of the flash-prefill kernel from raw queries: the
    q-side qk_norm and rope (each rounding to the query dtype, as the
    kernel's prologue does), then :func:`paged_prefill_plain`."""
    # layers imports ops, which imports this module: load the helpers late
    from repro_torch.models.layers import apply_rope, rms_head_norm

    qq = q if q_norm is None else rms_head_norm(q_norm, q, eps, plain=True)
    qq = apply_rope(qq, positions, rope_theta)
    return paged_prefill_plain(
        qq, k_pool, v_pool, tables, kv_len, scale=scale, window=window,
        layer=layer, q_start=q_start, q_block=q_block,
    )
