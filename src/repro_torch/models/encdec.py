"""Encoder-decoder LM (the seamless-m4t family), counterpart of
``repro.models.encdec``.

The encoder takes precomputed frame embeddings (the audio frontend is a
stub) through bidirectional self-attention; the decoder is a causal LM
that also attends, bidirectionally, over the encoder's output (the
memory).  Parameters keep the JAX tree: ``embedding``, ``unembed``,
``enc_final_norm``, ``final_norm`` and the layer-stacked ``encoder``
(``ln1``, ``ln2``, ``attn``, ``mlp``) and ``decoder`` (``ln1``,
``ln_cross``, ``ln2``, ``attn``, ``cross``, ``mlp``), each leaf ``[L,
...]``.  The serving cache (:func:`init_cache`) holds the decoder's
growing self-attention K/V and the cross-attention K/V, computed once from
the memory at :func:`prefill`; both are bfloat16 ``[L, B, T, K, dh]`` and
updated in place.

Under a tensor split (``models.split``; training only) every layer runs
Megatron's split as ``lm``'s dense blocks do: the layernorms whole, each
slice its heads of the self-attention, its kv heads and heads of the cross
attention (the memory, whole on every rank, entering each decoder layer's
slices) and its part of the GeGLU's width, the float32 parts summed and
rounded once; the decoder's embedding and the cross entropy over the
vocabulary slices.

Kernels: the three attentions take :func:`layers.attention`'s branches.
Past ``attn_kv_chunk`` keys, the encoder's self-attention (S = T, causal
off), the cross-attention (S queries over the T frames of the memory) and
the decoder's training self-attention (causal) run K2; the cached decoder
self-attention runs the plain chunked softmax and a decode step (S = 1)
the naive branch, as JAX leaves both to XLA.  Layernorm is plain PyTorch.
``plain=True`` runs K2's plain versions.

A ``Collector`` (MegaScope) sees JAX's tags at the same places:
``att_resid``, ``ffn_resid``, ``cross_attn_out`` and the attention and MLP
blocks' own (``q``, ``v``, ``k``, ``attn_probs``, ``attn_out``,
``mlp_hidden``).  Each layer's captures are drained after it and stacked
over the layer axis, under ``"encoder"`` and ``"decoder"``; a layer's
remat recompute re-tags with recording off, as ``lm.forward``'s does.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.hooks import NULL_COLLECTOR, Collector, LayerScoped
from repro_torch.models.split import WHOLE, Split

# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------


def cross_attn_init(b: L.ParamBuilder, cfg: ModelConfig) -> None:
    D, H, K, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b.param("wq", (D, H, dh), ("embed_w", "heads_w", "head_dim_w"), fan_in=D)
    b.param("wk", (D, K, dh), ("embed_w", "kv_heads_w", "head_dim_w"), fan_in=D)
    b.param("wv", (D, K, dh), ("embed_w", "kv_heads_w", "head_dim_w"), fan_in=D)
    b.param("wo", (H, dh, D), ("heads_w", "head_dim_w", "embed_w"), fan_in=H * dh,
            scale=1.0 / math.sqrt(2 * cfg.num_layers))


def cross_kv(p: dict, cfg: ModelConfig, memory: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The memory's K and V, ``[B, T, K, dh]`` in the memory's dtype."""
    return L._proj(memory, p["wk"]), L._proj(memory, p["wv"])


def cross_attn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     kv: tuple[torch.Tensor, torch.Tensor], *, plain: bool = False,
                     collector: Collector = NULL_COLLECTOR,
                     out_float32: bool = False) -> torch.Tensor:
    """The decoder stream ``x [B, S, D]`` attends over the memory's K/V
    ``[B, T, K, dh]``, bidirectionally: no rope, the queries at position 0
    as JAX places them (a bidirectional call reads no positions).
    ``out_float32``: the output product's float32 result, a tensor slice's
    part of it (``layers.matmul_float32``)."""
    B, S, D = x.shape
    H, dh = cfg.num_heads, cfg.head_dim
    q = L._proj(x, p["wq"])
    k, v = kv
    o = L.attention(q, k.to(x.dtype), v.to(x.dtype), scale=1.0 / math.sqrt(dh),
                    positions_q=torch.zeros(S, dtype=torch.long, device=x.device),
                    causal=False, impl=cfg.attn_impl, kv_chunk=cfg.attn_kv_chunk,
                    plain=plain, collector=collector)
    o = collector.tag("cross_attn_out", o)
    wo = p["wo"].to(x.dtype).reshape(H * dh, D)
    if out_float32:
        return L.matmul_float32(o.reshape(B * S, H * dh), wo).reshape(B, S, D)
    return o.reshape(B, S, H * dh) @ wo


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def enc_block_init(b: L.ParamBuilder, cfg: ModelConfig) -> None:
    L.norm_init(b, "ln1", cfg.d_model, cfg.norm_kind)
    L.norm_init(b, "ln2", cfg.d_model, cfg.norm_kind)
    L.gqa_init(b.sub("attn"), cfg)
    L.mlp_init(b.sub("mlp"), cfg)


def enc_block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                    positions: torch.Tensor, plain: bool = False,
                    collector: Collector = NULL_COLLECTOR,
                    split: Split = WHOLE) -> torch.Tensor:
    """One encoder layer: bidirectional self-attention, then the MLP.
    Under a tensor ``split`` each norm's output enters the slices' heads
    and ffn width, whose float32 parts are summed and rounded once into the
    residual, as ``lm``'s dense blocks run (the norms stay whole)."""
    local = split.cfg(cfg)
    h = L.norm_apply(p["ln1"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    a = split.sum(lambda t: L.gqa_apply(
        split.take(p["attn"], "encoder", ("attn",), t), local, split.enter(h),
        positions=positions, causal=False, plain=plain, collector=collector,
        out_float32=split.tensor))
    x = x + collector.tag("att_resid", a.to(x.dtype))
    h = L.norm_apply(p["ln2"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    return x + collector.tag("ffn_resid", _mlp(p, local, "encoder", h, collector, split))


def _mlp(p: dict, local: ModelConfig, kind: str, h: torch.Tensor,
         collector: Collector, split: Split) -> torch.Tensor:
    """A layer's MLP over the split's slices of its width, rounded once."""
    return split.sum(lambda t: L.mlp_apply(
        split.take(p["mlp"], kind, ("mlp",), t), local, split.enter(h), collector,
        out_float32=split.tensor)).to(h.dtype)


def dec_block_init(b: L.ParamBuilder, cfg: ModelConfig) -> None:
    L.norm_init(b, "ln1", cfg.d_model, cfg.norm_kind)
    L.norm_init(b, "ln_cross", cfg.d_model, cfg.norm_kind)
    L.norm_init(b, "ln2", cfg.d_model, cfg.norm_kind)
    L.gqa_init(b.sub("attn"), cfg)
    cross_attn_init(b.sub("cross"), cfg)
    L.mlp_init(b.sub("mlp"), cfg)


def dec_block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                    positions: torch.Tensor, memory: torch.Tensor | None = None,
                    mem_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
                    cache: dict | None = None, cache_pos: int | None = None,
                    plain: bool = False, collector: Collector = NULL_COLLECTOR,
                    split: Split = WHOLE) -> torch.Tensor:
    """One decoder layer.  With ``cache`` (this layer's views), the new
    self-attention K/V are written at ``cache_pos`` in place and attention
    reads the whole cache.  The cross attention reads ``mem_kv`` (the
    cache's ``ck``/``cv`` when serving) or computes the K/V of ``memory``
    itself (training).  Under a tensor ``split`` (training only) each
    sub-block runs over the slices of its heads or width as
    :func:`enc_block_apply`'s do, the memory whole on every rank entering
    each slice's kv heads of the cross attention."""
    local = split.cfg(cfg)
    h = L.norm_apply(p["ln1"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    self_cache = None if cache is None else {"k": cache["k"], "v": cache["v"]}
    a = split.sum(lambda t: L.gqa_apply(
        split.take(p["attn"], "decoder", ("attn",), t), local, split.enter(h),
        positions=positions, cache=self_cache, cache_pos=cache_pos, plain=plain,
        collector=collector, out_float32=split.tensor))
    x = x + collector.tag("att_resid", a.to(x.dtype))
    h = L.norm_apply(p["ln_cross"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)

    def cross(t: int) -> torch.Tensor:
        w = split.take(p["cross"], "decoder", ("cross",), t)
        kv = mem_kv if memory is None else cross_kv(w, local, split.enter(memory))
        return cross_attn_apply(w, local, split.enter(h), kv, plain=plain,
                                collector=collector, out_float32=split.tensor)

    x = x + split.sum(cross).to(x.dtype)
    h = L.norm_apply(p["ln2"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    return x + collector.tag("ffn_resid", _mlp(p, local, "decoder", h, collector, split))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def init(cfg: ModelConfig, *, seed: int = 0, device: str = "cuda",
         dtype: torch.dtype | None = None) -> dict:
    """Random float32 parameters from ``seed`` on ``device``, in JAX
    ``encdec.init``'s tree; with ``dtype``, each leaf cast as it is drawn,
    as ``lm.init`` does (norm scales and biases stay float32)."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"  # shapes and dtypes only
           else torch.Generator(device=dev).manual_seed(seed))
    b = L.ParamBuilder(gen, dev, cast=lm.cast_as_drawn(dtype))
    _build(b, cfg)
    return b.params


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axis names of every leaf of :func:`init`'s tree (JAX
    ``encdec.param_axes``), built on the ``meta`` device."""
    b = L.ParamBuilder(None, torch.device("meta"))
    _build(b, cfg)
    return b.axes


def _build(b: L.ParamBuilder, cfg: ModelConfig) -> None:
    L.embed_init(b, cfg)
    L.norm_init(b, "enc_final_norm", cfg.d_model, cfg.norm_kind)
    L.norm_init(b, "final_norm", cfg.d_model, cfg.norm_kind)
    enc_block_init(b.sub("encoder", lead=(cfg.num_encoder_layers,)), cfg)
    dec_block_init(b.sub("decoder", lead=(cfg.num_layers,)), cfg)


def _stack(stacked: dict, x: torch.Tensor, body, site: str, collector: Collector,
           remat: str, caches: dict | None = None
           ) -> tuple[torch.Tensor, dict]:
    """``x`` through every layer of the layer-stacked parameters
    ``stacked``: ``body(layer params, x, collector, layer cache)``, under
    ``torch.utils.checkpoint`` where ``remat`` says (``lm.forward``'s
    rules).  Returns ``(x, captures stacked over the layers)``."""
    live = collector is not NULL_COLLECTOR
    rows = []
    n = next(iter(lm.tree_leaves(stacked))).shape[0]
    for g in range(n):
        col = LayerScoped(collector, g, site) if live else collector
        args = (lm._layer(stacked, g), x, col,
                None if caches is None else lm._layer(caches, g))
        if remat == "full":
            x = checkpoint(body, *args, use_reentrant=False)
        elif remat == "dots":
            x = checkpoint(body, *args, use_reentrant=False,
                           context_fn=lm._dots_contexts)
        else:
            x = body(*args)
        if live:
            rows.append(col.drain())
            col.close()  # a recompute in the backward records nothing
    return x, (lm._stack(rows) if rows and rows[0] else {})


def _remat(cfg: ModelConfig, cached: bool) -> str:
    if cfg.remat not in ("full", "dots", "none"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return cfg.remat if not cached and torch.is_grad_enabled() else "none"


def encode(cfg: ModelConfig, params: dict, embeds: torch.Tensor, *,
           plain: bool = False, collector: Collector = NULL_COLLECTOR,
           split: Split = WHOLE) -> tuple[torch.Tensor, dict]:
    """The memory ``[B, T, D]`` of the frame embeddings ``[B, T, D]`` (in
    the compute dtype), and the encoder's captures; under a tensor
    ``split`` each layer runs its slices and the memory is whole."""
    x = embeds.to(getattr(torch, cfg.compute_dtype))
    positions = L.arange_positions(x.shape[1], x.device)

    def body(p, x, col, _):
        return enc_block_apply(p, cfg, x, positions=positions, plain=plain,
                               collector=col, split=split)

    x, captures = _stack(params["encoder"], x, body, "encoder", collector,
                         _remat(cfg, False))
    return L.norm_apply(params["enc_final_norm"], x, cfg.norm_kind, cfg.norm_eps,
                        plain=plain), captures


def _decode_stack(cfg: ModelConfig, params: dict, x: torch.Tensor,
                  memory: torch.Tensor | None, *, cache: dict | None = None,
                  cache_pos: int | None = None, plain: bool = False,
                  collector: Collector = NULL_COLLECTOR,
                  split: Split = WHOLE) -> tuple[torch.Tensor, dict]:
    """The decoder over ``x [B, S, D]``: without ``cache`` (training) each
    layer computes the memory's K/V itself, within its remat (under a
    tensor ``split``, each slice its kv heads); with it, the layers read
    the cache's ``ck``/``cv`` and write their self-attention K/V at
    ``cache_pos``, and a split is refused (serving is not split).  Returns
    (hidden after ``final_norm``, the decoder's captures)."""
    if split.tensor and cache is not None:
        raise NotImplementedError("the encoder-decoder's cache is not split over "
                                  "tensor ranks (sharded serving: ROADMAP queue 1, "
                                  "item 8c)")
    S = x.shape[1]
    positions = (L.arange_positions(S, x.device) if cache_pos is None
                 else torch.arange(cache_pos, cache_pos + S, device=x.device))

    def body(p, x, col, layer_cache):
        mem_kv = None if layer_cache is None else (layer_cache["ck"], layer_cache["cv"])
        return dec_block_apply(p, cfg, x, positions=positions, memory=memory,
                               mem_kv=mem_kv, cache=layer_cache, cache_pos=cache_pos,
                               plain=plain, collector=col, split=split)

    x, captures = _stack(params["decoder"], x, body, "decoder", collector,
                         _remat(cfg, cache is not None), caches=cache)
    return L.norm_apply(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps,
                        plain=plain), captures


def _captures(enc: dict, dec: dict) -> dict:
    return {k: v for k, v in (("encoder", enc), ("decoder", dec)) if v}


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            collector: Collector = NULL_COLLECTOR, *,
            plain: bool = False, split: Split | None = None
            ) -> tuple[torch.Tensor, dict]:
    """``(loss, metrics)`` as JAX ``encdec.loss_fn``: the source ``embeds``
    encoded, the target ``tokens`` decoded over the memory, the mean masked
    cross entropy against ``targets`` (optional ``loss_mask``); the metrics
    hold ``loss``, ``ce``, a zero ``aux_loss`` and, with a live
    ``collector``, its ``captures`` (``{"encoder": ..., "decoder": ...}``).
    Under a tensor ``split`` (``models.split``) the encoder's and the
    decoder's layers run their slices and the decoder's embedding and the
    cross entropy their vocabulary slices, as ``lm.loss_fn``'s do."""
    split = WHOLE if split is None else split
    memory, enc = encode(cfg, params, batch["embeds"], plain=plain,
                         collector=collector, split=split)
    x = L.embed_apply(params, cfg, batch["tokens"], getattr(torch, cfg.compute_dtype),
                      split)
    hidden, dec = _decode_stack(cfg, params, x, memory, plain=plain,
                                collector=collector, split=split)
    total, count = L.chunked_xent(params, cfg, hidden, batch["targets"],
                                  batch.get("loss_mask"), split)
    ce = total / torch.clamp(count, min=1.0)
    metrics = {"loss": ce, "ce": ce,
               "aux_loss": torch.zeros((), dtype=torch.float32, device=ce.device)}
    captures = _captures(enc, dec)
    if captures:
        metrics["captures"] = captures
    return ce, metrics


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, src_len: int | None = None,
               device: str | torch.device = "cuda") -> dict:
    """JAX ``encdec.init_cache``: bfloat16 self-attention ``k``/``v`` ``[L,
    batch, cache_len, K, dh]`` and cross-attention ``ck``/``cv`` ``[L,
    batch, src_len, K, dh]`` (``src_len`` defaults to ``cache_len``, as
    JAX's model entry does)."""
    dev = resolve_device(device)

    def zeros(n: int) -> torch.Tensor:
        return torch.zeros((cfg.num_layers, batch, n, cfg.num_kv_heads, cfg.head_dim),
                           dtype=torch.bfloat16, device=dev)

    src_len = src_len or cache_len
    return {"k": zeros(cache_len), "v": zeros(cache_len), "ck": zeros(src_len),
            "cv": zeros(src_len)}


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache: dict,
            collector: Collector = NULL_COLLECTOR, *,
            plain: bool = False) -> tuple[torch.Tensor, dict]:
    """JAX ``encdec.prefill``: encode ``batch["embeds"]`` (as many frames as
    the cache's ``src_len``), fill every layer's ``ck``/``cv`` with the
    memory's K/V rounded to bfloat16, then the target prompt
    ``batch["tokens"]`` through the decoder from position 0, writing its
    self-attention K/V.  The cache is updated in place; returns (the last
    position's logits ``[B, V]``, captures)."""
    memory, enc = encode(cfg, params, batch["embeds"], plain=plain,
                         collector=collector)
    if memory.shape[1] != cache["ck"].shape[2]:
        raise ValueError(f"{memory.shape[1]} source frames for a cache of "
                         f"src_len {cache['ck'].shape[2]}")
    for g in range(cfg.num_layers):
        k, v = cross_kv(lm._layer(params["decoder"]["cross"], g), cfg, memory)
        cache["ck"][g].copy_(k)
        cache["cv"][g].copy_(v)
    x = L.embed_apply(params, cfg, batch["tokens"], getattr(torch, cfg.compute_dtype))
    hidden, dec = _decode_stack(cfg, params, x, None, cache=cache, cache_pos=0,
                                plain=plain, collector=collector)
    return L.logits_fn(params, cfg, hidden[:, -1:])[:, 0], _captures(enc, dec)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
                pos: int, collector: Collector = NULL_COLLECTOR, *,
                plain: bool = False) -> tuple[torch.Tensor, dict]:
    """JAX ``encdec.decode_step``: one token a row at the shared ``pos``,
    over the cache (in place); returns (logits ``[B, V]``, captures)."""
    x = L.embed_apply(params, cfg, tokens.reshape(-1, 1),
                      getattr(torch, cfg.compute_dtype))
    hidden, dec = _decode_stack(cfg, params, x, None, cache=cache, cache_pos=int(pos),
                                plain=plain, collector=collector)
    return L.logits_fn(params, cfg, hidden)[:, 0], _captures({}, dec)
