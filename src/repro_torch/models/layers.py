"""Transformer building blocks of the dense GQA decoder and the MoE layer, in
PyTorch.

Counterparts of ``repro.models.layers`` with the same names and the same
layouts: ``wq [D, H, dh]``, ``wk``/``wv [D, K, dh]``, ``wo [H, dh, D]``, MLP
``w_gate``/``w_up [D, F]`` (no ``w_gate`` under relu2), ``w_down [F, D]``,
MoE ``router [D, E]``, experts ``w_gate``/``w_up [E, D, F]``, ``w_down [E,
F, D]``, MLA ``wq [D, H, nope + rope]``, ``wdkv [D, r]``, ``wkr [D, rope]``,
``kv_norm [r]``, ``wuk [r, H, nope]``, ``wuv [r, H, dv]``, ``wo [H, dv, D]``,
the embedding ``[padded_V, D]``.
Each matrix and bias is cast to the compute dtype at use, as
``p[...].astype(x.dtype)`` does there, while norm scales enter the float32
norm math in their own dtype (float32 when serving, the compute dtype in a
``TrainState``).  Rounding follows the JAX functions: norms and rope compute
in float32 and return the input dtype; products the JAX side asks in float32
(``preferred_element_type``) are float32 here.

Kernels: every RMSNorm goes through ``kernels.rmsnorm`` (K1) and the flash
branch of :func:`attention` through ``kernels.flash_attention`` (K2); the
paged branches of :func:`gqa_apply` go through ``kernels.paged_attention``
(K3, K4).  ``plain=True`` (``PagedInfo.plain`` when serving) selects the
plain PyTorch versions on any device: the card's reference runs.

Ported: the paged serving branches, the non-cached training branch of the
attention block and the dense cached branch (a KV cache written at
``cache_pos``; ``attention`` with a ``kv_len``, plain PyTorch as JAX leaves
it outside Pallas, which the gathered serving path and static serving run),
each windowed for Griffin, the non-paged ones also under M-RoPE (qwen2-vl);
MLA's full path (training and prefill, K2 with v's head dim apart from
q's) and its absorbed decode over the latent cache (:func:`mla_apply`);
the banded local-block path (plain PyTorch, as JAX computes it in jnp);
the bidirectional call (``causal=False``: the encoder-decoder's encoder
and cross-attention, K2 with S apart from T).  A ``Collector``
(MegaScope) sees the tags of the JAX functions at the same places: ``q``,
``v``, ``k``, ``attn_probs`` (naive branch only), ``attn_out``,
``mlp_hidden`` and ``router_gate``; over the pool, every branch but the fused
flash prefill, which JAX also leaves untagged and skips under a collector.
``norm_init`` also builds layernorm parameters (scale and bias; RWKV-6's
``ln_x`` group norm applies its own inline); ``norm_apply``'s layernorm is
plain PyTorch, as JAX computes it in jnp (K1 is RMSNorm only).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import (
    PagedInfo,
    paged_attention,
    paged_prefill,
    scatter_kv,
    write_kv,
)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_plain,
    paged_prefill_plain_from_raw,
)
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.models.hooks import NULL_COLLECTOR, Collector
from repro_torch.models.split import WHOLE

BIG_NEG = -1e30


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


class ParamBuilder:
    """Builds a params dict with ``torch.Generator``-seeded values and the JAX
    ``ParamBuilder``'s scale rules (normal: ``scale / sqrt(fan_in)``).

    ``lead`` prepends stacking axes (the layer axis of a segment), so a
    stacked leaf ``[n, *shape]`` holds ``n`` independent draws of ``shape``;
    ``cast(name, leaf)`` (if given) replaces each float32 leaf as it is
    drawn, so a cast tree is built without the float32 one beside it.
    The values differ from JAX's for the same seed; tests hand both sides the
    same weights through :mod:`repro_torch.models.weights`.

    ``axes`` mirrors ``params`` with each leaf's logical axis names (JAX's
    ``ParamBuilder.axes``; a stacked leaf leads with ``"layers"``), which
    ``parallel.sharding`` resolves onto a mesh.  On the ``meta`` device
    (``gen`` None) nothing is drawn: ``lm.param_axes`` builds the tree of
    axes that way, and the dryrun its parameters.
    """

    def __init__(self, gen: torch.Generator | None, device: torch.device,
                 lead: tuple[int, ...] = (), cast=None):
        self.gen = gen
        self.device = device
        self.lead = lead
        self.cast = cast  # (name, float32 leaf) -> the leaf kept, or None
        self.params: dict = {}
        self.axes: dict = {}

    def param(self, name: str, shape: tuple[int, ...],
              axes: tuple[str | None, ...], init: str = "normal",
              fan_in: int | None = None, scale: float = 1.0,
              fill: float = 0.0) -> None:
        assert len(shape) == len(axes), (name, shape, axes)
        self.axes[name] = ("layers",) * len(self.lead) + tuple(axes)
        full = (*self.lead, *shape)
        kw = dict(dtype=torch.float32, device=self.device)
        if self.gen is None:
            val = torch.empty(full, **kw)
            self.params[name] = val if self.cast is None else self.cast(name, val)
            return
        if init == "normal":
            fi = fan_in if fan_in is not None else shape[0]
            std = scale / math.sqrt(max(fi, 1))
            val = torch.randn(full, generator=self.gen, **kw).mul_(std)
        elif init == "zeros":
            val = torch.zeros(full, **kw)
        elif init == "ones":
            val = torch.ones(full, **kw)
        elif init == "const":
            val = torch.full(full, fill, **kw)
        elif init == "uniform":  # U(-scale, scale)
            val = (2 * torch.rand(full, generator=self.gen, **kw) - 1) * scale
        else:
            raise ValueError(init)
        self.params[name] = val if self.cast is None else self.cast(name, val)

    def sub(self, name: str, lead: tuple[int, ...] = ()) -> "ParamBuilder":
        child = ParamBuilder(self.gen, self.device, self.lead + lead, self.cast)
        self.params[name] = child.params
        self.axes[name] = child.axes
        return child


# ---------------------------------------------------------------------------
# Norms and rotary embeddings
# ---------------------------------------------------------------------------


def norm_init(b: ParamBuilder, name: str, dim: int, kind: str) -> None:
    if kind not in ("rmsnorm", "layernorm"):
        raise ValueError(f"unknown norm kind {kind!r}")
    s = b.sub(name)
    s.param("scale", (dim,), ("embed_w",), init="ones")
    if kind == "layernorm":
        s.param("bias", (dim,), ("embed_w",), init="zeros")


def norm_apply(p: dict, x: torch.Tensor, kind: str, eps: float, *,
               plain: bool = False) -> torch.Tensor:
    """RMSNorm through K1, or layernorm as JAX ``norm_apply`` computes it:
    in float32, the mean taken out, ``rsqrt`` of the variance plus ``eps``,
    then scale and bias, cast back to ``x``'s dtype."""
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"], eps, plain=plain)
    if kind != "layernorm":
        raise ValueError(f"unknown norm kind {kind!r}")
    xf = x.float()
    xf = xf - xf.mean(-1, keepdim=True)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float, *,
                  plain: bool = False) -> torch.Tensor:
    """Per-head-dim RMSNorm (qwen3 qk_norm): x [..., dh], scale [dh]."""
    return rmsnorm(x, scale, eps, plain=plain)


def rope_freqs(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, D] or [B, S, D]; positions [S] shared or [B, S] per row."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * freqs
    if x.dim() == 4:
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, position_ids: torch.Tensor,
                sections: tuple[int, ...], theta: float) -> torch.Tensor:
    """M-RoPE: x [B, S, H, D]; position_ids [3, B, S]; ``sections`` (t, h,
    w) sum to D/2 and split the frequencies, each section rotating with its
    own position stream."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    sec_id = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                        for i, n in enumerate(sections)])
    pos = position_ids.float()[sec_id].movedim(0, -1)  # [B, S, d/2]
    ang = (pos * freqs)[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention block over the paged pool
# ---------------------------------------------------------------------------


def gqa_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    D, H, K, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b.param("wq", (D, H, dh), ("embed_w", "heads_w", "head_dim_w"), fan_in=D)
    b.param("wk", (D, K, dh), ("embed_w", "kv_heads_w", "head_dim_w"), fan_in=D)
    b.param("wv", (D, K, dh), ("embed_w", "kv_heads_w", "head_dim_w"), fan_in=D)
    b.param("wo", (H, dh, D), ("heads_w", "head_dim_w", "embed_w"), fan_in=H * dh,
            scale=1.0 / math.sqrt(2 * cfg.num_layers))
    if cfg.qkv_bias:
        b.param("bq", (H, dh), ("heads_w", "head_dim_w"), init="zeros")
        b.param("bk", (K, dh), ("kv_heads_w", "head_dim_w"), init="zeros")
        b.param("bv", (K, dh), ("kv_heads_w", "head_dim_w"), init="zeros")
    if cfg.qk_norm:
        b.param("q_norm", (dh,), ("head_dim_w",), init="ones")
        b.param("k_norm", (dh,), ("head_dim_w",), init="ones")


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    D, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(D, h * k)).view(*x.shape[:-1], h, k)


def _mask(pq: torch.Tensor, pk: torch.Tensor, causal: bool,
          window: int | None, kv_len: torch.Tensor | None) -> torch.Tensor:
    """Bool mask broadcastable to ``[B?, S, C]``: True = attend."""
    q = pq[..., :, None]
    k = pk[None, :]
    m = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                   device=pk.device)
    if causal:
        m = m & (k <= q)
    if window is not None:
        m = m & (k > q - window)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=pk.device)
        m = m & (k < (kl[:, None, None] if kl.dim() == 1 else kl))
    return m


def arange_positions(S: int, device: torch.device) -> torch.Tensor:
    """``arange(S)``, marked as such: the flash branch of :func:`attention`
    takes these query positions without reading them back from the card."""
    pos = torch.arange(S, device=device)
    pos.is_arange = True
    return pos


def _check_rows_at_positions(positions_q: torch.Tensor, S: int) -> None:
    """The flash branch places query row ``i`` at position ``i``: a causal
    or windowed call must come with ``positions_q == arange(S)``.  Positions
    from :func:`arange_positions` pass unread; any others are read back and
    compared."""
    if tuple(positions_q.shape) == (S,) and (
            getattr(positions_q, "is_arange", False)
            or torch.equal(positions_q.cpu(), torch.arange(S))):
        return
    raise ValueError(
        "a causal or windowed flash call takes query row i at position i "
        f"(positions_q == arange({S})); use the cached path (kv_len) for "
        "queries at other positions")


def attention(
    q: torch.Tensor,             # [B, S, H, D]
    k: torch.Tensor,             # [B, T, K, D]
    v: torch.Tensor,             # [B, T, K, D]
    *,
    scale: float,
    positions_q: torch.Tensor,   # [S] absolute positions of the queries
    causal: bool = True,
    window: int | None = None,
    kv_len: torch.Tensor | int | None = None,
    impl: str = "chunked",
    kv_chunk: int = 1024,
    plain: bool = False,
    collector: Collector = NULL_COLLECTOR,
) -> torch.Tensor:
    """Non-paged attention with ``repro.models.layers.attention``'s dispatch.

    The naive branch (``S == 1``, ``impl == "naive"`` or ``T <= kv_chunk``)
    is plain PyTorch, as the JAX package leaves it to XLA; only it has
    probabilities to tag (``attn_probs``).  Without ``kv_len``, the flash
    branch (``impl="chunked"``) and the Pallas branch (``impl="pallas"``)
    both go to the flash-attention kernel (K2) and its backward; that
    branch places query row ``i`` at position ``i``, as the Pallas kernel
    does, so a causal or windowed call there raises unless ``positions_q
    == arange(S)`` (as on the training path); a bidirectional call
    (``causal=False``, no window: the encoder's self-attention and the
    cross-attention, whose queries JAX places at position 0) reads no
    positions.  ``impl="local_block"`` with a window dividing ``S == T``
    is JAX ``_local_block_attention`` (plain PyTorch).  With ``kv_len``
    (the dense cache), the flash branch is JAX ``_flash_forward``: the
    online softmax over ``kv_chunk`` chunks, in plain PyTorch.
    """
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if S == 1 or impl == "naive" or T <= kv_chunk:
        qg = q.reshape(B, S, K, G, D)
        s = torch.einsum("bskgd,btkd->bskgt", qg.float(), k.float()) * scale
        m = _mask(positions_q, torch.arange(T, device=q.device), causal,
                  window, kv_len)
        m = m.reshape(B if m.dim() == 3 else 1, S, 1, 1, T)
        p = torch.softmax(torch.where(m, s, BIG_NEG), dim=-1)
        p = collector.tag("attn_probs", p)
        o = torch.einsum("bskgt,btkd->bskgd", p.to(v.dtype).float(), v.float())
        return o.reshape(B, S, H, v.shape[-1]).to(q.dtype)
    if impl == "local_block" and window is not None and S == T and S % window == 0:
        return _local_block_attention(q.reshape(B, S, K, G, D), k, v, scale=scale,
                                      window=window).reshape(B, S, H, -1).to(q.dtype)
    if kv_len is not None:
        return _chunked_attention(q, k, v, scale=scale, positions_q=positions_q,
                                  causal=causal, window=window, kv_len=kv_len,
                                  kv_chunk=kv_chunk)
    if causal or window is not None:
        _check_rows_at_positions(positions_q, S)
    return flash_attention(q, k, v, scale=scale, causal=causal, window=window,
                           plain=plain)


def _local_block_attention(qg, k, v, *, scale, window):
    """JAX ``_local_block_attention``: each ``window``-row block of queries
    attends to its own key block and the one before it (keys ``j`` of the
    ``2W`` strip with ``i < j <= W + i``, the previous block's only past
    the first), float32 scores, probabilities rounded to v's dtype before
    the PV product, float32 ``[B, S, K, G, Dv]`` out."""
    B, S, K, G, D = qg.shape
    Dv = v.shape[-1]
    W = window
    nb = S // W
    qb = qg.reshape(B, nb, W, K, G, D)
    kb = k.reshape(B, nb, W, K, D)
    vb = v.reshape(B, nb, W, K, Dv)
    k2 = torch.cat([F.pad(kb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1], kb], dim=2)
    v2 = torch.cat([F.pad(vb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1], vb], dim=2)
    s = torch.einsum("bnwkgd,bnckd->bnwkgc", qb.float(), k2.float()) * scale
    i = torch.arange(W, device=qg.device)[:, None]
    j = torch.arange(2 * W, device=qg.device)[None, :]
    base = (j <= W + i) & (j > i)
    blk = torch.arange(nb, device=qg.device)[:, None, None]
    msk = torch.where(blk > 0, base[None], (base & (j >= W))[None])  # [nb, W, 2W]
    s = torch.where(msk[None, :, :, None, None, :], s, BIG_NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bnwkgc,bnckd->bnwkgd", p.to(v2.dtype).float(), v2.float())
    return o.reshape(B, S, K, G, Dv)


def _chunked_attention(q, k, v, *, scale, positions_q, causal, window, kv_len,
                       kv_chunk):
    """JAX ``_flash_forward``: a running max, sum and output over key chunks
    of ``kv_chunk`` (float32 scores, probabilities rounded to v's dtype
    before the PV product).  JAX pads the last chunk with zero keys, which
    the ``kv_len`` mask drops; a short last chunk here is the same sum."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // K
    qg = q.reshape(B, S, K, G, D).float()
    m_r = torch.full((B, S, K, G), BIG_NEG, dtype=torch.float32, device=q.device)
    l_r = torch.zeros((B, S, K, G), dtype=torch.float32, device=q.device)
    o_r = torch.zeros((B, S, K, G, Dv), dtype=torch.float32, device=q.device)
    for c0 in range(0, T, kv_chunk):
        kb, vb = k[:, c0:c0 + kv_chunk], v[:, c0:c0 + kv_chunk]
        C = kb.shape[1]
        s = torch.einsum("bskgd,bckd->bskgc", qg, kb.float()) * scale
        msk = _mask(positions_q, torch.arange(c0, c0 + C, device=q.device),
                    causal, window, kv_len)
        s = torch.where(msk.reshape(B if msk.dim() == 3 else 1, S, 1, 1, C),
                        s, BIG_NEG)
        m_new = torch.maximum(m_r, s.amax(-1))
        corr = torch.exp(m_r - m_new)
        p = torch.exp(s - m_new[..., None])
        l_r = l_r * corr + p.sum(-1)
        o_r = o_r * corr[..., None] + torch.einsum(
            "bskgc,bckd->bskgd", p.to(vb.dtype).float(), vb.float())
        m_r = m_new
    o = o_r / torch.where(l_r[..., None] == 0, 1.0, l_r[..., None])
    return o.reshape(B, S, H, Dv).to(q.dtype)


def gqa_apply(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,             # [B, S, D]
    *,
    positions: torch.Tensor,     # [S] (training, cached) or [B, S] (paged)
    window: int | None = None,   # sliding window (Griffin's local attention)
    causal: bool = True,         # False: the encoder's bidirectional attention
    pool: dict | None = None,    # {"k", "v"}: [n_layers, NB, bs, K, dh], in place
    paged: PagedInfo | None = None,
    plain: bool = False,
    collector: Collector = NULL_COLLECTOR,
    cache: dict | None = None,   # {"k", "v"}: [B, T, K, dh] bf16, in place
    cache_pos: int | None = None,
    mrope_position_ids: torch.Tensor | None = None,  # [3, B, S]
    out_float32: bool = False,
) -> torch.Tensor:
    """The attention block.

    Without a pool or a cache this is the training branch (``cache is
    None`` in JAX): qk_norm on q and k, rope on both, then
    :func:`attention` over the ``window``, ``causal`` or not (the
    encoder's self-attention is bidirectional); ``plain`` selects the plain
    norm and attention.  With a dense ``cache`` (JAX's ``elif cache is not None``
    branch) the roped new K and V are written into it at ``cache_pos`` and
    attention reads all of it with ``kv_len = cache_pos + S``.  Both tag
    ``q``, ``v``, ``k`` and ``attn_out`` into ``collector``, and rotate q
    and k by M-RoPE where the config has sections and
    ``mrope_position_ids`` are given (qwen2-vl), 1-D rope otherwise.  With
    a pool (no served arch has M-RoPE, so the pool branches take no ids)
    ``paged.prefill`` with more than one query is the fused
    flash-prefill branch: the raw q goes to the kernel, whose prologue
    applies qk_norm and rope.  Otherwise this is paged decode: rope q,
    write the new K/V into the pool at ``positions``, and attend with
    ``kv_len = positions[:, -1] + 1`` under the ``window`` (Griffin's
    local attention) through K3.
    """
    B, S, D = x.shape
    H, K, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q, kk, vv = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        kk = kk + p["bk"].to(dt)
        vv = vv + p["bv"].to(dt)
    scale = 1.0 / math.sqrt(dh)
    q_norm = p["q_norm"] if cfg.qk_norm else None
    k_norm = p["k_norm"] if cfg.qk_norm else None
    if pool is None:
        if cfg.qk_norm:
            q = rms_head_norm(q_norm, q, cfg.norm_eps, plain=plain)
            kk = rms_head_norm(k_norm, kk, cfg.norm_eps, plain=plain)
        if cfg.mrope_sections and mrope_position_ids is not None:
            rot = lambda t: apply_mrope(t, mrope_position_ids,  # noqa: E731
                                        cfg.mrope_sections, cfg.rope_theta)
        else:
            rot = lambda t: apply_rope(t, positions, cfg.rope_theta)  # noqa: E731
        q = collector.tag("q", rot(q))
        vv = collector.tag("v", vv)
        kk = collector.tag("k", rot(kk))
        kv_len = None
        if cache is not None:
            cache["k"][:, cache_pos:cache_pos + S] = kk.to(cache["k"].dtype)
            cache["v"][:, cache_pos:cache_pos + S] = vv.to(cache["v"].dtype)
            kk, vv = cache["k"].to(dt), cache["v"].to(dt)
            kv_len = cache_pos + S
        o = attention(q, kk, vv, scale=scale, positions_q=positions,
                      causal=causal, window=window, kv_len=kv_len, impl=cfg.attn_impl,
                      kv_chunk=cfg.attn_kv_chunk, plain=plain,
                      collector=collector)
        o = collector.tag("attn_out", o)
    else:
        o = _paged_attention_block(q, kk, vv, cfg, positions, pool, paged,
                                   scale, q_norm, k_norm, window, collector)
    wo = p["wo"].to(dt)
    if out_float32:  # a tensor rank's part of the product (models.pipeline)
        return matmul_float32(o.to(dt).reshape(B * S, H * dh),
                              wo.reshape(H * dh, D)).reshape(B, S, D)
    return o.to(dt).reshape(B, S, H * dh) @ wo.reshape(H * dh, D)


class _MatmulFloat32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.dtype == torch.float32:
            return a @ b
        if not a.is_cpu:  # the card, or the meta device standing in for it
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ b.T, a.T @ g


def matmul_float32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` in ``a``'s dtype with a float32 result (the
    product's float32 sums, not rounded to bf16).  Under tensor
    parallelism each rank holds a part of K: the ranks' float32 parts sum to
    what the whole product rounds once, as the fused step's bf16 product
    does, where bf16 parts would be rounded twice.  The backward is the
    bf16 product's, its cotangent in ``a``'s dtype."""
    return _MatmulFloat32.apply(a, b)


def _paged_attention_block(q, kk, vv, cfg, positions, pool, paged, scale,
                           q_norm, k_norm, window, collector):
    """The pool branches of :func:`gqa_apply`.  ``paged.prefill`` with more
    than one query and no live collector is the fused flash-prefill branch
    (K4, its q prologue in the kernel): a full prompt, a chunk over a cached
    prefix or a verify step.  Otherwise (decode, or any Q under a
    collector, whose tags need the roped q and k) this is JAX's generic
    paged branch: norm and rope q and k, tag ``q``, ``v``, ``k``, scatter
    K/V into the pool and attend through the block table (K3), tag
    ``attn_out``."""
    S = q.shape[1]
    dt = q.dtype
    kv = dict(tables=paged.tables, positions=positions,
              block_size=paged.block_size, layer=paged.layer)
    if paged.prefill and S > 1 and collector is NULL_COLLECTOR:
        rope = dict(k_norm=k_norm, eps=cfg.norm_eps, rope_theta=cfg.rope_theta)
        if paged.plain:
            kv_len = write_kv(kk, vv, pool["k"], pool["v"], **kv, **rope,
                              plain=True)
            return paged_prefill_plain_from_raw(
                q, pool["k"], pool["v"], paged.tables, kv_len,
                positions=positions, scale=scale, layer=paged.layer,
                q_norm=q_norm, eps=cfg.norm_eps, rope_theta=cfg.rope_theta,
                q_start=paged.q_start, window=window,
            )
        return paged_prefill(
            q, kk, vv, pool["k"], pool["v"], scale=scale, q_norm=q_norm,
            q_start=paged.q_start, window=window, **kv, **rope,
        )
    if cfg.qk_norm:
        q = rms_head_norm(q_norm, q, cfg.norm_eps, plain=paged.plain)
        kk = rms_head_norm(k_norm, kk, cfg.norm_eps, plain=paged.plain)
    q = collector.tag("q", apply_rope(q, positions, cfg.rope_theta))
    vv = collector.tag("v", vv)
    kk = collector.tag("k", apply_rope(kk, positions, cfg.rope_theta))
    kv_len = scatter_kv(kk, vv, pool["k"], pool["v"], **kv)
    attend = paged_attention_plain if paged.plain else paged_attention
    o = attend(q.to(dt), pool["k"], pool["v"], tables=paged.tables,
               kv_len=kv_len, scale=scale, window=window, layer=paged.layer)
    return collector.tag("attn_out", o)


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    b.param("wq", (D, H, dq), ("embed_w", "heads_w", "head_dim_w"), fan_in=D)
    b.param("wdkv", (D, m.kv_lora_rank), ("embed_w", "kv_lora_w"), fan_in=D)
    b.param("wkr", (D, m.qk_rope_head_dim), ("embed_w", "head_dim_w"), fan_in=D)
    b.param("kv_norm", (m.kv_lora_rank,), ("kv_lora_w",), init="ones")
    b.param("wuk", (m.kv_lora_rank, H, m.qk_nope_head_dim), ("kv_lora_w", "heads_w", "head_dim_w"),
            fan_in=m.kv_lora_rank)
    b.param("wuv", (m.kv_lora_rank, H, m.v_head_dim), ("kv_lora_w", "heads_w", "head_dim_w"),
            fan_in=m.kv_lora_rank)
    b.param("wo", (H, m.v_head_dim, D), ("heads_w", "head_dim_w", "embed_w"),
            fan_in=H * m.v_head_dim,
            scale=1.0 / math.sqrt(2 * cfg.num_layers))


def _mla_qkr(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The no-rope and the roped parts of the queries, ``[B, S, H, nope]``
    and ``[B, S, H, rope]``."""
    m = cfg.mla
    q = _proj(x, p["wq"])
    qn = q[..., :m.qk_nope_head_dim]
    qr = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return qn, qr


def mla_apply(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,             # [B, S, D]
    *,
    positions: torch.Tensor,     # [S]
    cache: dict | None = None,   # {"ckv": [B, T, r], "kpe": [B, T, dr]} bf16, in place
    cache_pos: int | None = None,
    paged: PagedInfo | None = None,
    plain: bool = False,
    collector: Collector = NULL_COLLECTOR,
    split=WHOLE,
    kind: str = "dense",
) -> torch.Tensor:
    """JAX ``mla_apply``: queries ``wq`` (no query compression) split into a
    no-rope and a roped part; the latent ``ckv = kv_norm(x wdkv)`` (K1) and
    the roped shared key part ``kpe = rope(x wkr)``.

    With a dense ``cache`` and one query (absorbed decode) the new latent
    and ``kpe`` are written at ``cache_pos`` and attention runs in the
    latent space over the whole cache: the queries absorb ``wuk``, scores
    in float32 over ``ckv`` and ``kpe``, masked past ``kv_len = cache_pos +
    1``, the softmax tagged ``attn_probs``, the context over ``ckv`` in
    float32 rounded to the compute dtype, then ``wuv`` and ``wo``; plain
    PyTorch, as JAX leaves it to XLA.  Otherwise (training and prefill) the
    full path up-projects ``kn = ckv wuk`` and ``v = ckv wuv``, broadcasts
    ``kpe`` over the heads into the keys and runs :func:`attention` with q
    and k at head dim ``nope + rope`` and v at ``v_head_dim`` (K2 on its
    flash branch, at (192, 128) for deepseek-v2-lite); a prefill with a
    cache writes the padded latent and ``kpe`` into it.  The paged pool is
    refused: the latent cache has no kv-head axis for the paged kernels to
    walk (MLA serves on the gathered path).

    Under a tensor ``split`` (training only; ``kind`` is the block's, the
    slice table's key) ``ckv`` and ``kpe`` are computed whole before the
    boundary and enter the slices with ``x``; each slice takes its heads of
    ``wq``, ``wuk``, ``wuv`` and ``wo`` and returns its float32 part of the
    output product, and the parts are summed (Megatron's MLA: the down
    projections replicated, the up projections split by heads)."""
    if paged is not None:
        raise NotImplementedError("paged decode does not support MLA")
    if split.tensor and cache is not None:
        raise NotImplementedError("MLA's latent cache is not split over tensor ranks "
                                  "(sharded serving: ROADMAP queue 1, item 8c)")
    m = cfg.mla
    B, S, D = x.shape
    dt = x.dtype
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    local = split.cfg(cfg)
    w = {t: split.take({k: p[k] for k in ("wq", "wuk", "wuv", "wo")}, kind, ("attn",), t)
         for t in split.slices}
    # the queries first: x's gradient then sums its uses in the order it
    # always has, so the fused path stays bit for bit what it was
    q = {t: _mla_qkr(w[t], local, split.enter(x), positions) for t in split.slices}
    ckv = rmsnorm(x @ p["wdkv"].to(dt), p["kv_norm"], cfg.norm_eps, plain=plain)
    kpe = apply_rope(x @ p["wkr"].to(dt), positions, cfg.rope_theta)

    if cache is not None and S == 1:
        # absorbed decode: attend in the latent space (compressed KV cache)
        qn, qr = q[0]
        cache["ckv"][:, cache_pos:cache_pos + 1] = ckv.to(cache["ckv"].dtype)
        cache["kpe"][:, cache_pos:cache_pos + 1] = kpe.to(cache["kpe"].dtype)
        ckv_c, kpe_c = cache["ckv"].to(dt), cache["kpe"].to(dt)
        T = ckv_c.shape[1]
        q_lat = torch.einsum("bshk,rhk->bshr", qn, p["wuk"].to(dt))
        s = (torch.einsum("bshr,btr->bsht", q_lat.float(), ckv_c.float())
             + torch.einsum("bshk,btk->bsht", qr.float(), kpe_c.float())) * scale
        msk = torch.arange(T, device=x.device) < cache_pos + 1
        prob = torch.softmax(torch.where(msk, s, BIG_NEG), dim=-1)
        prob = collector.tag("attn_probs", prob)
        ctx = torch.einsum("bsht,btr->bshr", prob.to(dt).float(), ckv_c.float()).to(dt)
        o = torch.einsum("bshr,rhv->bshv", ctx, p["wuv"].to(dt))
        return torch.einsum("bshv,hvd->bsd", o, p["wo"].to(dt))

    # full (training / prefill) path, over the split's head slices
    r = m.kv_lora_rank
    H = local.num_heads

    def part(t: int) -> torch.Tensor:
        (qn, qr), c, kp = q[t], split.enter(ckv), split.enter(kpe)
        kn = (c @ w[t]["wuk"].to(dt).reshape(r, -1)).view(B, S, H, m.qk_nope_head_dim)
        vv = (c @ w[t]["wuv"].to(dt).reshape(r, -1)).view(B, S, H, m.v_head_dim)
        k_full = torch.cat(
            [kn, kp[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
        q_full = torch.cat([qn, qr], dim=-1)
        o = attention(q_full, k_full, vv, scale=scale, positions_q=positions,
                      causal=True, impl=cfg.attn_impl, kv_chunk=cfg.attn_kv_chunk,
                      plain=plain, collector=collector)
        return split.out(o.reshape(B, S, H * m.v_head_dim),
                         w[t]["wo"].reshape(H * m.v_head_dim, D))

    out = split.sum(part)
    if cache is not None:  # prefill fills the compressed cache, zeros past S
        for name, new in (("ckv", ckv), ("kpe", kpe)):
            cache[name][:, :S] = new.to(cache[name].dtype)
            cache[name][:, S:].zero_()
    return out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(b: ParamBuilder, cfg: ModelConfig, d_ff: int | None = None) -> None:
    D, Fd = cfg.d_model, d_ff if d_ff is not None else cfg.d_ff
    if cfg.mlp_kind in ("swiglu", "geglu"):
        b.param("w_gate", (D, Fd), ("embed_w", "mlp_w"), fan_in=D)
    b.param("w_up", (D, Fd), ("embed_w", "mlp_w"), fan_in=D)
    b.param("w_down", (Fd, D), ("mlp_w", "embed_w"), fan_in=Fd,
            scale=1.0 / math.sqrt(2 * cfg.num_layers))


def mlp_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              collector: Collector = NULL_COLLECTOR, *,
              out_float32: bool = False) -> torch.Tensor:
    """SwiGLU, GeGLU (the tanh form of gelu, which ``jax.nn.gelu``
    computes by default) or the non-gated squared ReLU.  Tags the hidden
    ``mlp_hidden``.  ``out_float32``: the down product's float32 result
    (:func:`matmul_float32`), a tensor rank's part of it."""
    dt = x.dtype
    h = x @ p["w_up"].to(dt)
    if cfg.mlp_kind == "relu2":
        h = torch.square(F.relu(h))
    elif cfg.mlp_kind in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(dt)
        act = F.silu(g) if cfg.mlp_kind == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * h
    else:
        raise ValueError(cfg.mlp_kind)
    h = collector.tag("mlp_hidden", h)
    if out_float32:
        F_ = h.shape[-1]
        return matmul_float32(h.reshape(-1, F_), p["w_down"].to(dt)).reshape(
            *h.shape[:-1], -1)
    return h @ p["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Mixture of experts (sort-based dispatch)
# ---------------------------------------------------------------------------


def moe_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    D, mo = cfg.d_model, cfg.moe
    E, Fd = mo.num_experts, mo.expert_d_ff
    b.param("router", (D, E), ("embed_w", None), fan_in=D)
    b.param("w_gate", (E, D, Fd), ("expert_w", "embed_w", "expert_mlp"), fan_in=D)
    b.param("w_up", (E, D, Fd), ("expert_w", "embed_w", "expert_mlp"), fan_in=D)
    b.param("w_down", (E, Fd, D), ("expert_w", "expert_mlp", "embed_w"), fan_in=Fd,
            scale=1.0 / math.sqrt(2 * cfg.num_layers))
    if mo.num_shared_experts:
        mlp_init(b.sub("shared"), cfg.replace(mlp_kind="swiglu"),
                 d_ff=mo.num_shared_experts * Fd)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the ``k`` largest along the last axis, equal
    values in index order (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(t [G, N, D], idx[..., None], axis=1)``: rows of
    each group, ``idx`` [G, M] -> [G, M, D]."""
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              n_seq_groups: int = 1,
              collector: Collector = NULL_COLLECTOR,
              split=None,
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Top-k routed SwiGLU experts with a capacity, JAX ``moe_apply``.

    Tokens are viewed as ``[G, Cg, D]`` groups (``G = B x n_seq_groups``
    when ``n_seq_groups`` divides S, else one group a row); each group
    routes on its own: softmax over the router's logits, the top ``k``
    renormalised (tagged ``router_gate``), at most ``cap = ceil(Cg k / E
    capacity_factor)`` entries an expert.  The dispatch sorts the group's
    (token, choice) entries by expert (a stable sort, so an expert keeps
    its earliest tokens), builds the slot -> token table (a zero pad row
    for empty slots), runs each expert's SwiGLU on its slots and gathers
    every entry's output back through the inverse permutation, an entry
    past its expert's capacity reading a zero row (dropped).  Shared
    experts add a plain SwiGLU.  Returns ``(y [B, S, D], aux)``: ``aux``
    holds ``moe_aux_loss`` (the Switch load-balance loss and the z-loss,
    scaled by their coefficients) and ``moe_drop_frac`` (the share of
    entries dropped, no gradient).  The expert products are plain batched
    products, as in JAX, where no Pallas kernel computes them.

    Under a tensor ``split`` (``models.split``) the router, the aux losses
    and the dispatch tables are computed whole, the same on every rank;
    the token rows and the gates enter the slices' experts (``E / tp``
    each, ``expert_w`` sliced), each slice combines only its experts'
    outputs in float32, and the slices' parts are summed; the shared
    experts' SwiGLU runs over the slices of its width (``mlp_w``), its
    float32 parts summed and rounded once, and is added to the rounded
    routed output as the fused path adds the two.  Over ``split.dp``
    data ranks (a routing group is a row's, so a rank's rows route as in
    the whole batch) the expert counts are summed over the data ranks and
    the load-balance and z-loss terms are this rank's partial sums over
    its rows divided by the whole batch's counts: the data ranks' terms sum
    to the whole batch's aux loss."""
    mo = cfg.moe
    B, S, D = x.shape
    E, K = mo.num_experts, mo.top_k
    dt, dev = x.dtype, x.device
    nsg = n_seq_groups if S % max(n_seq_groups, 1) == 0 else 1
    Cg = S // nsg
    G = B * nsg
    N = Cg * K
    xt = x.reshape(G, Cg, D)

    logits = (xt @ p["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = _top_k(probs, K)                      # [G, Cg, K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    gate = collector.tag("router_gate", gate)

    # aux losses (Switch-style load balance + z-loss)
    # each expert's entry count (``bincount``, which the meta device lacks)
    flat = eidx.reshape(-1)
    counts = torch.zeros(E, dtype=flat.dtype, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat)).float()
    if split is not None and split.dp > 1:
        # this rank's part of the whole batch's terms
        G_all = G * split.dp
        me = probs.sum(dim=(0, 1)) / (G_all * Cg)
        ce = split.data_sum(counts) / (G_all * N)
        aux_z = torch.square(torch.logsumexp(logits, dim=-1)).sum() / (G_all * Cg)
    else:
        me = probs.mean(dim=(0, 1))
        ce = counts / (G * N)
        aux_z = torch.square(torch.logsumexp(logits, dim=-1)).mean()
    aux_lb = (me * ce).sum() * E * mo.router_aux_coef
    aux_z = aux_z * mo.router_z_coef

    cap = max(int(math.ceil(Cg * K / E * mo.capacity_factor)), 1)

    # sort-based dispatch: the slot -> token table, then one gather
    flat_e = eidx.reshape(G, N)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # [G, N] sorted entries
    sorted_e = torch.gather(flat_e, 1, order)
    first = torch.searchsorted(
        sorted_e, torch.arange(E + 1, device=dev).expand(G, E + 1).contiguous())
    # slot (e, c) holds sorted entry j = first[e] + c while j < first[e + 1]
    j = first[:, :E, None] + torch.arange(cap, device=dev)
    valid = j < first[:, 1:, None]
    tok_sorted = order // K                             # token of each entry
    # each entry's slot, E * cap where it is dropped
    inv = torch.argsort(order, dim=-1, stable=True)     # entry -> sorted position
    slot_sorted = (torch.arange(N, device=dev)[None, :]
                   - torch.gather(first[:, :E], 1, sorted_e))
    dest_sorted = torch.where(slot_sorted < cap, sorted_e * cap + slot_sorted, E * cap)
    slot_entry = torch.gather(dest_sorted, 1, inv)      # [G, N]
    tok_for_slot = torch.where(
        valid,
        torch.gather(tok_sorted, 1, torch.clamp(j, max=N - 1).reshape(G, E * cap)
                     ).reshape(G, E, cap),
        Cg)                                             # -> the zero pad row
    xt_pad = F.pad(xt, (0, 0, 0, 1))
    split = WHOLE if split is None else split
    y = split.sum(lambda t: _moe_experts(p, cfg, split, t, xt_pad, gate, tok_for_slot,
                                         slot_entry, cap)).to(dt)

    if mo.num_shared_experts:  # a SwiGLU over the split's mlp_w slices
        swiglu = cfg.replace(mlp_kind="swiglu")
        y = y + split.sum(lambda t: mlp_apply(
            split.take(p["shared"], "moe", ("mlp", "shared"), t), swiglu,
            split.enter(xt), out_float32=split.tensor)).to(dt)

    aux = {"moe_aux_loss": aux_lb + aux_z,
           "moe_drop_frac": (slot_entry == E * cap).float().mean()}
    return y.reshape(B, S, D), aux


def _moe_experts(p: dict, cfg: ModelConfig, split, t: int, xt_pad: torch.Tensor,
                 gate: torch.Tensor, tok_for_slot: torch.Tensor,
                 slot_entry: torch.Tensor, cap: int) -> torch.Tensor:
    """Slice ``t``'s experts (``E / tp``, ``expert_w`` sliced; all of them
    under :data:`models.split.WHOLE`) on their capacity slots, and the
    combine: per top-k choice, each entry routed to one of them adds its
    gate-weighted slot output (``[G, Cg, D]``).  The token rows and the
    gates enter the slice; under the split its part is added in float32
    (the product in the compute dtype, as the fused combine takes it), the
    fused combine adds in the compute dtype."""
    G, Cg, K = gate.shape
    D, dt = xt_pad.shape[-1], xt_pad.dtype
    E_t = cfg.moe.num_experts // split.tp
    rows = E_t * cap
    xe, ge = split.enter(xt_pad), split.enter(gate)
    tok = tok_for_slot[:, t * E_t:(t + 1) * E_t].reshape(G, rows)
    expert_in = _rows(xe, tok).reshape(G, E_t, cap, D)
    w = {k: split.cut(p[k], 0, t).to(dt) for k in ("w_up", "w_gate", "w_down")}
    h_up = torch.einsum("gecd,edf->gecf", expert_in, w["w_up"])
    h_g = torch.einsum("gecd,edf->gecf", expert_in, w["w_gate"])
    expert_out = torch.einsum("gecf,efd->gecd", F.silu(h_g) * h_up, w["w_down"])
    flat_out = F.pad(expert_out.reshape(G, rows, D), (0, 0, 0, 1))
    local = slot_entry
    if split.tensor:  # another slice's entries -> the zero row
        local = slot_entry - t * rows
        local = torch.where((local >= 0) & (local < rows), local, rows)
    acc = torch.float32 if split.tensor else dt
    y = torch.zeros((G, Cg, D), dtype=acc, device=xt_pad.device)
    for k in range(K):                                  # entries (t, k) at t*K + k
        y = y + (_rows(flat_out, local[:, k::K]) * ge[:, :, k, None].to(dt)).to(acc)
    return y


# ---------------------------------------------------------------------------
# Embedding, logits
# ---------------------------------------------------------------------------


def embed_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    b.param("embedding", (cfg.padded_vocab, cfg.d_model), ("vocab_w", "embed_w"),
            fan_in=cfg.d_model)
    if not cfg.tie_embeddings:
        b.param("unembed", (cfg.d_model, cfg.padded_vocab), ("embed_w", "vocab_w"),
                 fan_in=cfg.d_model)


def _in_slice(ids: torch.Tensor, lo: int, hi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``ids``' places in the vocabulary slice ``[lo, hi)``: the local index
    (0 outside the slice) and whether each id falls in it."""
    ok = (ids >= lo) & (ids < hi)
    return torch.where(ok, ids - lo, 0), ok


def embed_apply(p: dict, cfg: ModelConfig, tokens: torch.Tensor,
                dtype: torch.dtype, split=WHOLE) -> torch.Tensor:
    """The token embeddings, scaled by ``scale_emb``.  Under a tensor
    ``split`` each slice gathers the rows of the tokens in its vocabulary
    range and zeros for the rest, and the slices' parts are summed (one is
    nonzero: exact); a slice's gradient is its own tokens' rows."""
    def rows(t: int) -> torch.Tensor:
        w = split.cut(p["embedding"], 0, t)
        if not split.tensor:
            return w[tokens]
        local, ok = _in_slice(tokens, *split.vocab_range(cfg, t))
        return w[local].masked_fill(~ok[..., None], 0)

    x = split.sum(rows).to(dtype)
    if cfg.scale_emb != 1.0:
        x = x * cfg.scale_emb
    return x


def _unembed_matrix(p: dict, cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    if cfg.tie_embeddings:
        return p["embedding"].to(dtype).T
    return p["unembed"].to(dtype)


def _mask_padded_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    col = torch.arange(cfg.padded_vocab, device=logits.device)
    return logits.masked_fill(col >= cfg.vocab_size, BIG_NEG)


def logits_fn(p: dict, cfg: ModelConfig, y: torch.Tensor) -> torch.Tensor:
    """Full logits (serving path): y [B, S, D] -> [B, S, padded_V] with the
    padded columns masked to ``BIG_NEG``."""
    w = _unembed_matrix(p, cfg, y.dtype)
    if cfg.dim_model_base:
        y = y / (cfg.d_model / cfg.dim_model_base)
    return _mask_padded_vocab(cfg, y @ w)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result from operands of one dtype, as JAX's
    ``preferred_element_type=float32``: bfloat16 products accumulate and
    return in float32 (on the CPU through float32 copies of the operands)."""
    if a.dtype == torch.float32:
        return a @ b
    if not a.is_cpu:  # the card, or the meta device standing in for it
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _ChunkedCE(torch.autograd.Function):
    """``_make_ce``'s custom VJP: the forward sums ``(lse - target logit) *
    mask`` chunk by chunk over the sequence; the backward recomputes each
    chunk's logits, takes the analytic softmax gradient and rounds ``dlog``
    to the weight dtype before its two products, so ``dy`` and ``dw`` leave
    in the model dtype.  Never materialises ``[B, S, V]``.

    Under a tensor ``split`` (Megatron's vocab-parallel cross entropy) ``w``
    is this rank's columns (the whole matrix without a group: every slice
    here) and each slice's logits stay local: a row's ``lse`` is the max
    over the slices (:meth:`Split.max`) plus the log of the summed
    exponentials, its target logit the owning slice's; the forward keeps
    each chunk's ``lse``, so the backward's ``prob = exp(l - lse)`` is
    local, the ``-1`` goes on the owning slice and ``dw`` stays the
    slice's.  In a world each rank's float32 partial product of ``dy`` is
    summed over the ranks and rounded once; without a group the slices'
    ``dlog`` lie side by side and ``dy`` is one product, rounded once, as
    the fused step's (a float32 sum of the slices' products moves a
    gradient by its own rounding noise, which the one-process split is held
    below).  At tp 1 this is the fused arithmetic."""

    @staticmethod
    def forward(ctx, y, w, t, m, nchunks, c, cfg, split):
        ctx.shape = (nchunks, c, cfg, split)
        total = torch.zeros((), dtype=torch.float32, device=y.device)
        lses = []
        for i in range(nchunks):
            sl = slice(i * c, (i + 1) * c)
            logits = {s: _ce_logits(y[:, sl], w, cfg, split, s) for s in split.slices}
            if split.tensor:
                mx = split.max(lambda s: logits[s].amax(-1))
                lse = mx + torch.log(split.sum(
                    lambda s: torch.exp(logits[s] - mx[..., None]).sum(-1)))
                lses.append(lse)
            else:
                lse = torch.logsumexp(logits[0], dim=-1)

            def target(s: int) -> torch.Tensor:
                local, ok = _in_slice(t[:, sl].long(), *split.vocab_range(cfg, s))
                return torch.where(ok, torch.gather(logits[s], -1, local[..., None])[..., 0],
                                   0.0)

            tgt = split.sum(target)
            total = total + ((lse - tgt) * m[:, sl]).sum()
        ctx.save_for_backward(y, w, t, m, *lses)
        return total, m.sum()

    @staticmethod
    def backward(ctx, g_total, _g_count):
        y, w, t, m, *lses = ctx.saved_tensors
        nchunks, c, cfg, split = ctx.shape
        g = g_total.float()
        B, _, D = y.shape
        dy_chunks, dw = [], {}
        for i in range(nchunks):
            sl = slice(i * c, (i + 1) * c)
            yc = y[:, sl]
            dlogs = {}
            for s in split.slices:
                logits = _ce_logits(yc, w, cfg, split, s)
                prob = (torch.exp(logits - lses[i][..., None]) if split.tensor
                        else torch.softmax(logits, dim=-1))
                local, ok = _in_slice(t[:, sl].long(), *split.vocab_range(cfg, s))
                prob.scatter_add_(-1, local[..., None], -ok[..., None].float())
                dlog = (prob * (m[:, sl] * g)[..., None]).to(w.dtype)
                dlogs[s] = dlog.reshape(-1, dlog.shape[-1])
                dw_c = _mm_f32(yc.reshape(-1, D).t(), dlogs[s])
                if s not in dw:
                    dw[s] = dw_c
                else:  # in place: two float32 [D, V] buffers alive, not three
                    dw[s].add_(dw_c)
                del dw_c
            if split.group is None:  # every slice here: one product over them all
                dy = _mm_f32(torch.cat([dlogs[s] for s in split.slices], 1)
                             if split.tensor else dlogs[0], w.t())
            else:  # this rank's float32 partial product, summed over the ranks
                dy = split.sum(lambda s: _mm_f32(dlogs[s], w.t()))
            dy_chunks.append(dy.reshape(B, -1, D).to(y.dtype))
        dw = [dw.pop(s).to(w.dtype) for s in split.slices]
        return (torch.cat(dy_chunks, dim=1), dw[0] if len(dw) == 1 else torch.cat(dw, 1),
                None, None, None, None, None, None)


def _ce_logits(yc: torch.Tensor, w: torch.Tensor, cfg: ModelConfig, split,
               s: int) -> torch.Tensor:
    """Slice ``s``'s float32 logits of the chunk ``yc``, the padded columns
    (by their index in the whole vocabulary) masked to ``BIG_NEG``."""
    B, c, D = yc.shape
    logits = _mm_f32(yc.reshape(B * c, D), split.cut(w, 1, s)).reshape(B, c, -1)
    lo, hi = split.vocab_range(cfg, s)
    if hi > cfg.vocab_size:
        col = torch.arange(lo, hi, device=logits.device)
        logits = logits.masked_fill(col >= cfg.vocab_size, BIG_NEG)
    return logits


def chunked_xent(p: dict, cfg: ModelConfig, y: torch.Tensor,
                 targets: torch.Tensor, loss_mask: torch.Tensor | None = None,
                 split=WHOLE) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequence-chunked cross entropy over the (tied or separate) unembed;
    returns ``(sum_loss, sum_count)`` in float32.  Under a tensor ``split``
    the vocabulary is sliced over the tensor ranks (:class:`_ChunkedCE`)."""
    B, S, _ = y.shape
    w = _unembed_matrix(p, cfg, y.dtype)
    if cfg.dim_model_base:
        y = y / (cfg.d_model / cfg.dim_model_base)
    c = min(cfg.logits_chunk, S)
    nchunks = max(S // c, 1)
    c = S // nchunks
    mask = (loss_mask.float() if loss_mask is not None
            else torch.ones((B, S), dtype=torch.float32, device=y.device))
    return _ChunkedCE.apply(y, w, targets, mask, nchunks, c, cfg, split)
