"""Transformer building blocks of the dense GQA decoder, in PyTorch.

Counterparts of ``repro.models.layers`` with the same names and the same
layouts: ``wq [D, H, dh]``, ``wk``/``wv [D, K, dh]``, ``wo [H, dh, D]``, MLP
``w_gate``/``w_up [D, F]``, ``w_down [F, D]``, the embedding ``[padded_V, D]``.
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
each windowed for Griffin; the local-block path arrives with a later slice.
A ``Collector`` (MegaScope) sees the tags of the JAX functions at the same
places: ``q``, ``v``, ``k``, ``attn_probs`` (naive branch only),
``attn_out`` and ``mlp_hidden``; over the pool, every branch but the fused
flash prefill, which JAX also leaves untagged and skips under a collector.
``norm_init`` also builds layernorm parameters (scale and bias, for
RWKV-6's ``ln_x`` group norm, which ``models/rwkv.py`` applies inline);
``norm_apply`` takes rmsnorm only.
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

BIG_NEG = -1e30


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


class ParamBuilder:
    """Builds a params dict with ``torch.Generator``-seeded values and the JAX
    ``ParamBuilder``'s scale rules (normal: ``scale / sqrt(fan_in)``).

    ``lead`` prepends stacking axes (the layer axis of a segment), so a
    stacked leaf ``[n, *shape]`` holds ``n`` independent draws of ``shape``.
    The values differ from JAX's for the same seed; tests hand both sides the
    same weights through :mod:`repro_torch.models.weights`.
    """

    def __init__(self, gen: torch.Generator, device: torch.device,
                 lead: tuple[int, ...] = ()):
        self.gen = gen
        self.device = device
        self.lead = lead
        self.params: dict = {}

    def param(self, name: str, shape: tuple[int, ...], init: str = "normal",
              fan_in: int | None = None, scale: float = 1.0,
              fill: float = 0.0) -> None:
        full = (*self.lead, *shape)
        kw = dict(dtype=torch.float32, device=self.device)
        if init == "normal":
            fi = fan_in if fan_in is not None else shape[0]
            std = scale / math.sqrt(max(fi, 1))
            val = torch.randn(full, generator=self.gen, **kw) * std
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
        self.params[name] = val

    def sub(self, name: str, lead: tuple[int, ...] = ()) -> "ParamBuilder":
        child = ParamBuilder(self.gen, self.device, self.lead + lead)
        self.params[name] = child.params
        return child


# ---------------------------------------------------------------------------
# Norms and rotary embeddings
# ---------------------------------------------------------------------------


def norm_init(b: ParamBuilder, name: str, dim: int, kind: str) -> None:
    if kind not in ("rmsnorm", "layernorm"):
        raise ValueError(f"unknown norm kind {kind!r}")
    s = b.sub(name)
    s.param("scale", (dim,), init="ones")
    if kind == "layernorm":
        s.param("bias", (dim,), init="zeros")


def norm_apply(p: dict, x: torch.Tensor, kind: str, eps: float, *,
               plain: bool = False) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"{kind}: ported with the families that use it (ROADMAP queue 1)")
    return rmsnorm(x, p["scale"], eps, plain=plain)


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


# ---------------------------------------------------------------------------
# GQA attention block over the paged pool
# ---------------------------------------------------------------------------


def gqa_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    D, H, K, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b.param("wq", (D, H, dh), fan_in=D)
    b.param("wk", (D, K, dh), fan_in=D)
    b.param("wv", (D, K, dh), fan_in=D)
    b.param("wo", (H, dh, D), fan_in=H * dh,
            scale=1.0 / math.sqrt(2 * cfg.num_layers))
    if cfg.qkv_bias:
        b.param("bq", (H, dh), init="zeros")
        b.param("bk", (K, dh), init="zeros")
        b.param("bv", (K, dh), init="zeros")
    if cfg.qk_norm:
        b.param("q_norm", (dh,), init="ones")
        b.param("k_norm", (dh,), init="ones")


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
    branch places query row ``i`` at position ``i`` (``positions_q ==
    arange(S)``, as on the training path), as the Pallas kernel does.  With
    ``kv_len`` (the dense cache), the flash branch is JAX ``_flash_forward``:
    the online softmax over ``kv_chunk`` chunks, in plain PyTorch.
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
        raise NotImplementedError(
            "local_block attention (no config selects it) is not ported "
            "(ROADMAP queue 1, item 13b)")
    if kv_len is not None:
        return _chunked_attention(q, k, v, scale=scale, positions_q=positions_q,
                                  causal=causal, window=window, kv_len=kv_len,
                                  kv_chunk=kv_chunk)
    return flash_attention(q, k, v, scale=scale, causal=causal, window=window,
                           plain=plain)


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
    pool: dict | None = None,    # {"k", "v"}: [n_layers, NB, bs, K, dh], in place
    paged: PagedInfo | None = None,
    plain: bool = False,
    collector: Collector = NULL_COLLECTOR,
    cache: dict | None = None,   # {"k", "v"}: [B, T, K, dh] bf16, in place
    cache_pos: int | None = None,
) -> torch.Tensor:
    """The attention block.

    Without a pool or a cache this is the training branch (``cache is
    None`` in JAX): qk_norm on q and k, rope on both, then
    :func:`attention` over the ``window``; ``plain`` selects the plain norm
    and attention.  With a dense ``cache`` (JAX's ``elif cache is not None``
    branch) the roped new K and V are written into it at ``cache_pos`` and
    attention reads all of it with ``kv_len = cache_pos + S``.  Both tag
    ``q``, ``v``, ``k`` and ``attn_out`` into ``collector``.  With a pool
    (serving), ``paged.prefill`` with more than one query is the fused
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
        q = collector.tag("q", apply_rope(q, positions, cfg.rope_theta))
        vv = collector.tag("v", vv)
        kk = collector.tag("k", apply_rope(kk, positions, cfg.rope_theta))
        kv_len = None
        if cache is not None:
            cache["k"][:, cache_pos:cache_pos + S] = kk.to(cache["k"].dtype)
            cache["v"][:, cache_pos:cache_pos + S] = vv.to(cache["v"].dtype)
            kk, vv = cache["k"].to(dt), cache["v"].to(dt)
            kv_len = cache_pos + S
        o = attention(q, kk, vv, scale=scale, positions_q=positions,
                      window=window, kv_len=kv_len, impl=cfg.attn_impl,
                      kv_chunk=cfg.attn_kv_chunk, plain=plain,
                      collector=collector)
        o = collector.tag("attn_out", o)
    else:
        o = _paged_attention_block(q, kk, vv, cfg, positions, pool, paged,
                                   scale, q_norm, k_norm, window, collector)
    wo = p["wo"].to(dt)
    return o.to(dt).reshape(B, S, H * dh) @ wo.reshape(H * dh, D)


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
# MLP, embedding, logits
# ---------------------------------------------------------------------------


def mlp_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    D, Fd = cfg.d_model, cfg.d_ff
    b.param("w_gate", (D, Fd), fan_in=D)
    b.param("w_up", (D, Fd), fan_in=D)
    b.param("w_down", (Fd, D), fan_in=Fd,
            scale=1.0 / math.sqrt(2 * cfg.num_layers))


def mlp_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              collector: Collector = NULL_COLLECTOR) -> torch.Tensor:
    """SwiGLU or GeGLU; the GeGLU gate is the tanh form of gelu, which
    ``jax.nn.gelu`` computes by default.  Tags the gated hidden
    ``mlp_hidden``."""
    if cfg.mlp_kind not in ("swiglu", "geglu"):
        raise NotImplementedError(
            f"mlp_kind={cfg.mlp_kind}: ported with the families that use it "
            "(ROADMAP queue 1)")
    dt = x.dtype
    h = x @ p["w_up"].to(dt)
    g = x @ p["w_gate"].to(dt)
    act = F.silu(g) if cfg.mlp_kind == "swiglu" else F.gelu(g, approximate="tanh")
    return collector.tag("mlp_hidden", act * h) @ p["w_down"].to(dt)


def embed_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    b.param("embedding", (cfg.padded_vocab, cfg.d_model), fan_in=cfg.d_model)
    if not cfg.tie_embeddings:
        b.param("unembed", (cfg.d_model, cfg.padded_vocab), fan_in=cfg.d_model)


def embed_apply(p: dict, cfg: ModelConfig, tokens: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    x = p["embedding"][tokens].to(dtype)
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
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _ChunkedCE(torch.autograd.Function):
    """``_make_ce``'s custom VJP: the forward sums ``(lse - target logit) *
    mask`` chunk by chunk over the sequence; the backward recomputes each
    chunk's logits, takes the analytic softmax gradient and rounds ``dlog``
    to the weight dtype before its two products, so ``dy`` and ``dw`` leave
    in the model dtype.  Never materialises ``[B, S, V]``."""

    @staticmethod
    def forward(ctx, y, w, t, m, nchunks, c, vocab_real):
        ctx.save_for_backward(y, w, t, m)
        ctx.shape = (nchunks, c, vocab_real)
        total = torch.zeros((), dtype=torch.float32, device=y.device)
        for i in range(nchunks):
            sl = slice(i * c, (i + 1) * c)
            logits = _ce_logits(y[:, sl], w, vocab_real)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1, t[:, sl, None].long())[..., 0]
            total = total + ((lse - tgt) * m[:, sl]).sum()
        return total, m.sum()

    @staticmethod
    def backward(ctx, g_total, _g_count):
        y, w, t, m = ctx.saved_tensors
        nchunks, c, vocab_real = ctx.shape
        g = g_total.float()
        B, _, D = y.shape
        dy_chunks, dw = [], None
        for i in range(nchunks):
            sl = slice(i * c, (i + 1) * c)
            yc = y[:, sl]
            prob = torch.softmax(_ce_logits(yc, w, vocab_real), dim=-1)
            prob.scatter_add_(-1, t[:, sl, None].long(),
                              torch.full_like(prob[..., :1], -1.0))
            dlog = (prob * (m[:, sl] * g)[..., None]).to(w.dtype)
            dlog2 = dlog.reshape(-1, dlog.shape[-1])
            dy_chunks.append(_mm_f32(dlog2, w.t()).reshape(B, -1, D).to(y.dtype))
            dw_c = _mm_f32(yc.reshape(-1, D).t(), dlog2)
            dw = dw_c if dw is None else dw + dw_c
        return (torch.cat(dy_chunks, dim=1), dw.to(w.dtype), None, None, None,
                None, None)


def _ce_logits(yc: torch.Tensor, w: torch.Tensor, vocab_real: int) -> torch.Tensor:
    B, c, D = yc.shape
    logits = _mm_f32(yc.reshape(B * c, D), w).reshape(B, c, -1)
    if logits.shape[-1] != vocab_real:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(col >= vocab_real, BIG_NEG)
    return logits


def chunked_xent(p: dict, cfg: ModelConfig, y: torch.Tensor,
                 targets: torch.Tensor, loss_mask: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequence-chunked cross entropy over the (tied or separate) unembed;
    returns ``(sum_loss, sum_count)`` in float32."""
    B, S, _ = y.shape
    w = _unembed_matrix(p, cfg, y.dtype)
    if cfg.dim_model_base:
        y = y / (cfg.d_model / cfg.dim_model_base)
    c = min(cfg.logits_chunk, S)
    nchunks = max(S // c, 1)
    c = S // nchunks
    mask = (loss_mask.float() if loss_mask is not None
            else torch.ones((B, S), dtype=torch.float32, device=y.device))
    return _ChunkedCE.apply(y, w, targets, mask, nchunks, c, cfg.vocab_size)
