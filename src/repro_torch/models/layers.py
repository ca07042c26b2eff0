"""Transformer building blocks of the dense GQA decoder, in PyTorch.

Counterparts of ``repro.models.layers`` with the same names and the same
layouts: ``wq [D, H, dh]``, ``wk``/``wv [D, K, dh]``, ``wo [H, dh, D]``, MLP
``w_gate``/``w_up [D, F]``, ``w_down [F, D]``, the embedding ``[padded_V, D]``.
Parameters are float32; each matrix and bias is cast to the compute dtype at
use, as ``p[...].astype(x.dtype)`` does there (a copy cast once at load gives
the same values), while norm scales enter the float32 norm math uncast.
Rounding follows the JAX functions: norms and rope compute in float32 and
return the input dtype.

Only the two paged branches of the attention block are ported in this slice
(flash prefill and paged decode over a layer-stacked bfloat16 pool); the dense
cached, gathered and training paths arrive with later slices.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention.ops import (
    PagedInfo,
    paged_attention,
    paged_prefill,
    write_kv,
)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_plain,
    paged_prefill_plain_from_raw,
)

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
              fan_in: int | None = None, scale: float = 1.0) -> None:
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
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"{kind}: ported with the families that use it (ROADMAP queue 1)")
    b.sub(name).param("scale", (dim,), init="ones")


def norm_apply(p: dict, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"{kind}: ported with the families that use it (ROADMAP queue 1)")
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head-dim RMSNorm (qwen3 qk_norm): x [..., dh], scale [dh]."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


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


def gqa_apply(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,             # [B, S, D]
    *,
    positions: torch.Tensor,     # [B, S] absolute positions
    pool: dict,                  # {"k", "v"}: [n_layers, NB, bs, K, dh], in place
    paged: PagedInfo,
) -> torch.Tensor:
    """The attention block straight against the paged pool.

    ``paged.prefill`` with more than one query is the fused flash-prefill
    branch: the raw q goes to the kernel, whose prologue applies qk_norm and
    rope.  Otherwise this is paged decode: rope q, write the new K/V into the
    pool at ``positions``, and attend with ``kv_len = positions[:, -1] + 1``.
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
    kv = dict(tables=paged.tables, positions=positions,
              block_size=paged.block_size, layer=paged.layer, k_norm=k_norm,
              eps=cfg.norm_eps, rope_theta=cfg.rope_theta)
    if paged.prefill and S > 1:
        if paged.plain:
            kv_len = write_kv(kk, vv, pool["k"], pool["v"], **kv)
            o = paged_prefill_plain_from_raw(
                q, pool["k"], pool["v"], paged.tables, kv_len,
                positions=positions, scale=scale, layer=paged.layer,
                q_norm=q_norm, eps=cfg.norm_eps, rope_theta=cfg.rope_theta,
                q_start=paged.q_start,
            )
        else:
            o = paged_prefill(
                q, kk, vv, pool["k"], pool["v"], scale=scale, q_norm=q_norm,
                q_start=paged.q_start, **kv,
            )
    else:
        if cfg.qk_norm:
            q = rms_head_norm(q_norm, q, cfg.norm_eps)
        q = apply_rope(q, positions, cfg.rope_theta)
        kv_len = write_kv(kk, vv, pool["k"], pool["v"], **kv)
        attend = paged_attention_plain if paged.plain else paged_attention
        o = attend(q.to(dt), pool["k"], pool["v"], tables=paged.tables,
                   kv_len=kv_len, scale=scale, layer=paged.layer)
    wo = p["wo"].to(dt)
    return o.to(dt).reshape(B, S, H * dh) @ wo.reshape(H * dh, D)


# ---------------------------------------------------------------------------
# MLP, embedding, logits
# ---------------------------------------------------------------------------


def mlp_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    D, Fd = cfg.d_model, cfg.d_ff
    b.param("w_gate", (D, Fd), fan_in=D)
    b.param("w_up", (D, Fd), fan_in=D)
    b.param("w_down", (Fd, D), fan_in=Fd,
            scale=1.0 / math.sqrt(2 * cfg.num_layers))


def mlp_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_kind != "swiglu":
        raise NotImplementedError(
            f"mlp_kind={cfg.mlp_kind}: ported with the families that use it "
            "(ROADMAP queue 1)")
    dt = x.dtype
    h = x @ p["w_up"].to(dt)
    g = x @ p["w_gate"].to(dt)
    return (F.silu(g) * h) @ p["w_down"].to(dt)


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
