"""Decoder-only LM assembly for the dense GQA, MoE (with MLA attention),
RWKV-6 and Griffin families, in PyTorch.

Counterpart of ``repro.models.lm``.  Parameters keep the JAX tree: per-layer
leaves of segment ``i`` are stacked ``[n_groups, ...]`` under
``params["seg{i}"]["b{j}"]``, and so are the serving caches: a dense cache
(:func:`init_cache`) and the paged pool (:func:`init_pool`) mirror JAX's
``lm.init_cache`` tree, attention blocks holding ``k``/``v`` (MLA blocks the
latent ``ckv`` and ``kpe``) and recurrent blocks their carried state.
``forward`` is a Python loop over layers that indexes each layer's
parameters and its layer of every stacked cache leaf in place, never a
sliced copy.  Three forwards are ported:

* the paged serving forward (``pool`` given): attention blocks write their
  new K/V into the pool's blocks and read them through ``paged.tables``;
  recurrent blocks read and overwrite their slot rows of the pool's state
  leaves (``[n, num_slots, ...]``), every slot a batch row;
* the dense cached forward (``cache`` given, batch rows of its own, written
  at ``cache_pos``): serving's segment prefill and MegaScope's
  ``generate_with_scope``;
* the training forward (neither: the ``cache is None`` path of JAX
  ``lm.forward``) that :func:`loss_fn` differentiates, with ``cfg.remat`` as
  ``torch.utils.checkpoint`` around each layer (selective for ``"dots"``).

A ``Collector`` (MegaScope) rides all three forwards; each layer's captures
are stacked over the layer axis into ``aux["captures"]``, and on the paged
forward every tag keeps the slot axis as its batch axis, as the JAX
package's batched paged step does.
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention.ops import PagedInfo
from repro_torch.models import griffin as gf
from repro_torch.models import layers as L
from repro_torch.models import rwkv as rk
from repro_torch.models.hooks import NULL_COLLECTOR, Collector, LayerScoped
from repro_torch.models.split import WHOLE, Split

# leaves that enter float32 math uncast in the JAX package: norm scales and
# layernorm biases, qk_norm, MLA's latent norm, RWKV-6's decay base, decay
# LoRA output and bonus, Griffin's Lambda.  Every other leaf is cast to the
# compute dtype at use, so a copy cast once at load gives the same values
_NORM_LEAVES = ("scale", "bias", "q_norm", "k_norm", "kv_norm", "w0", "w_decay2",
                "u", "lam")
# block kinds whose cache is attention K/V (paged in the pool); the others
# carry a recurrent state (a row per slot)
_ATTENTION_KINDS = ("dense", "moe", "attn")


def segment_layout(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    """Returns [(block_kinds_per_group, n_groups), ...] covering all layers."""
    if cfg.family == "rwkv6":
        return [(("rwkv",), cfg.num_layers)]
    if cfg.family == "griffin":  # pattern groups, then the remainder
        pat = cfg.griffin.pattern
        n_full, rem = divmod(cfg.num_layers, len(pat))
        return ([(pat, n_full)] if n_full else []) + (
            [(pat[:rem], 1)] if rem else [])
    if cfg.family not in ("dense", "moe"):  # the encoder-decoder: models/encdec.py
        raise ValueError(cfg.family)
    if cfg.family == "moe":  # first_k_dense dense layers, then the MoE ones
        fk = cfg.moe.first_k_dense
        return ([(("dense",), fk)] if fk else []) + [
            (("moe",), cfg.num_layers - fk)]
    return [(("dense",), cfg.num_layers)]


def init(cfg: ModelConfig, *, seed: int = 0, device: str = "cuda",
         dtype: torch.dtype | None = None) -> dict:
    """Random float32 parameters from ``seed``, built on ``device``.  With
    ``dtype``, each leaf is cast as it is drawn, as :func:`cast_params`
    casts (``_NORM_LEAVES`` stay float32): the same values as a float32
    init cast afterwards, without the float32 tree beside the cast (a
    model whose float32 tree and cast would not fit on the card together,
    deepseek-v2-lite's 62.8 GB beside 31.4 GB)."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"  # shapes and dtypes only
           else torch.Generator(device=dev).manual_seed(seed))
    b = L.ParamBuilder(gen, dev, cast=cast_as_drawn(dtype))
    _build(b, cfg)
    return b.params


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axis names of every leaf of :func:`init`'s tree (JAX
    ``lm.param_axes``): stacked leaves lead with ``"layers"``.  Built on
    the ``meta`` device, so nothing is drawn."""
    b = L.ParamBuilder(None, torch.device("meta"))
    _build(b, cfg)
    return b.axes


def _build(b: L.ParamBuilder, cfg: ModelConfig) -> None:
    L.embed_init(b, cfg)
    L.norm_init(b, "final_norm", cfg.d_model, cfg.norm_kind)
    for i, (kinds, n) in enumerate(segment_layout(cfg)):
        seg = b.sub(f"seg{i}", lead=(n,))
        for j, kind in enumerate(kinds):
            blk = seg.sub(f"b{j}")
            if kind == "rwkv":
                rk.rwkv_block_init(blk, cfg)
                continue
            if kind in ("rec", "attn"):
                gf.griffin_block_init(blk, cfg, kind)
                continue
            L.norm_init(blk, "ln1", cfg.d_model, cfg.norm_kind)
            L.norm_init(blk, "ln2", cfg.d_model, cfg.norm_kind)
            (L.mla_init if cfg.use_mla else L.gqa_init)(blk.sub("attn"), cfg)
            (L.moe_init if kind == "moe" else L.mlp_init)(blk.sub("mlp"), cfg)


def cast_as_drawn(dtype: torch.dtype | None):
    """The ``ParamBuilder`` cast of an init in ``dtype``: every leaf but
    ``_NORM_LEAVES`` to ``dtype`` as it is drawn (None: float32 kept)."""
    if dtype is None:
        return None
    return lambda name, v: v if name in _NORM_LEAVES else v.to(dtype)


def cast_params(params: dict, dtype: torch.dtype, device: torch.device) -> dict:
    """A copy on ``device`` with every matrix and bias in ``dtype`` (the
    leaves JAX takes in float32, ``_NORM_LEAVES``, stay float32): what
    ``forward`` would cast to at each use."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = cast_params(v, dtype, device)
        else:
            out[k] = v.to(device=device,
                          dtype=torch.float32 if k in _NORM_LEAVES else dtype)
    return out


def _block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                 device: torch.device) -> dict:
    """One layer's cache, JAX ``lm.init_cache``'s ``one_group`` entry."""
    if kind == "rwkv":
        return rk.rwkv_init_state(cfg, batch, device)
    if kind in ("rec", "attn"):
        return gf.griffin_init_state(cfg, kind, batch, cache_len, device)
    if cfg.use_mla:  # the compressed latent and the shared roped key part
        m = cfg.mla
        return {n: torch.zeros((batch, cache_len, w), dtype=torch.bfloat16, device=device)
                for n, w in (("ckv", m.kv_lora_rank), ("kpe", m.qk_rope_head_dim))}
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {n: torch.zeros(shape, dtype=torch.bfloat16, device=device)
            for n in ("k", "v")}


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of nested dicts of one structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_leaves(tree: dict) -> list:
    """The leaves of nested dicts, in insertion order."""
    return [x for v in tree.values()
            for x in (tree_leaves(v) if isinstance(v, dict) else [v])]


def _cache_tree(cfg: ModelConfig, leaf_fn) -> dict:
    """``{"seg{i}": {"b{j}": ...}}`` with each leaf of a one-row, one-position
    block cache (on the meta device) replaced by ``leaf_fn(template leaf,
    n_groups, paged)``."""
    out = {}
    for i, (kinds, n) in enumerate(segment_layout(cfg)):
        out[f"seg{i}"] = {
            f"b{j}": tree_map(lambda t, n=n, kind=kind: leaf_fn(
                t, n, kind in _ATTENTION_KINDS),
                _block_cache(cfg, kind, 1, 1, torch.device("meta")))
            for j, kind in enumerate(kinds)}
    return out


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: str | torch.device = "cuda") -> dict:
    """The dense cache of JAX ``lm.init_cache``: per segment and block, the
    block's cache stacked over the segment's groups ``[n, batch, ...]``:
    bfloat16 ``k``/``v`` of ``cache_len`` positions for attention blocks
    (MLA's ``ckv [n, batch, cache_len, r]`` and ``kpe [.., rope]``), the
    float32 recurrent state for RWKV-6 and Griffin's recurrent blocks."""
    dev = resolve_device(device)

    def leaf(t, n, paged):
        shape = (n, batch, cache_len, *t.shape[2:]) if paged else (n, batch, *t.shape[1:])
        return torch.zeros(shape, dtype=t.dtype, device=dev)

    return _cache_tree(cfg, leaf)


def paged_flags(cfg: ModelConfig) -> dict:
    """The leaf-kind tree of the pool, JAX ``PagedKVCache.paged``: True for
    a paged leaf (attention ``k``/``v``, ``[n, num_blocks, bs, K, dh]``;
    MLA's ``ckv``/``kpe``, ``[n, num_blocks, bs, width]``, no head axis),
    False for a slot-state leaf (``[n, num_slots, ...]``)."""
    return _cache_tree(cfg, lambda t, n, paged: paged)


def init_pool(cfg: ModelConfig, num_blocks: int, block_size: int,
              device: torch.device, num_slots: int = 1) -> dict:
    """The serving pool, :func:`init_cache`'s tree with every attention leaf
    paged (bfloat16 ``[n, num_blocks, block_size, K, dh]``; block 0 is the
    null block) and every state leaf a float32 row per slot
    (``[n, num_slots, ...]``)."""

    def leaf(t, n, paged):
        shape = ((n, num_blocks, block_size, *t.shape[2:]) if paged
                 else (n, num_slots, *t.shape[1:]))
        return torch.zeros(shape, dtype=t.dtype, device=device)

    return _cache_tree(cfg, leaf)


def _layer(tree: dict, g: int) -> dict:
    return {k: _layer(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


def _resid(cfg: ModelConfig, x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    if cfg.scale_depth:
        return x + delta * (cfg.scale_depth / math.sqrt(cfg.num_layers))
    return x + delta


def _store(state: dict, new: dict) -> None:
    """Overwrite a layer's state views with its new state, in place."""
    for k, v in new.items():
        if isinstance(v, dict):
            _store(state[k], v)
        else:
            state[k].copy_(v)


def _block(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
           positions: torch.Tensor, paged: PagedInfo | None, plain: bool,
           collector: Collector = NULL_COLLECTOR, state: dict | None = None,
           cache_pos: int | None = None,
           mrope_position_ids: torch.Tensor | None = None,
           split: Split | None = None
           ) -> tuple[torch.Tensor, dict]:
    """One decoder layer (``_block_apply``'s rwkv, griffin, dense and moe
    branches, attention by MLA where the config says so): ``(x, aux)``,
    ``aux`` the MoE layer's ``moe_aux_loss`` and ``moe_drop_frac`` (``{}``
    for the other kinds), returned rather than accumulated so a remat
    recompute in the backward adds nothing.
    ``state`` is the layer's cache: with ``paged``, an attention
    block's is the pool's stacked ``{"k", "v"}`` (its layer is
    ``paged.layer``); otherwise views of this layer's dense cache rows, or a
    recurrent block's slot rows of the pool.  Attention writes its K/V in
    place; a recurrent block's new state is copied over its views.
    ``split`` (training only): the block runs its tensor slices
    (``models.split``)."""
    if kind in ("rwkv", "rec"):
        if kind == "rwkv":
            x, new = rk.rwkv_block_apply(p, cfg, x, state=state, plain=plain,
                                         collector=collector, split=split)
        else:
            x, new = gf.griffin_block_apply(p, cfg, kind, x, positions=positions,
                                            state=state, plain=plain,
                                            collector=collector, split=split)
        if state is not None:
            _store(state, new)
        return x, {}
    if kind == "attn":
        return gf.griffin_block_apply(p, cfg, kind, x, positions=positions,
                                      state=state, cache_pos=cache_pos,
                                      paged=paged, plain=plain,
                                      collector=collector, split=split)[0], {}
    # dense and MoE layers: under a tensor split each norm's output enters
    # the slices' attention heads (MLA's: mla_apply) and ffn width (or
    # experts: moe_apply), whose float32 products are summed and rounded
    # once into the residual
    split = WHOLE if split is None else split
    local = split.cfg(cfg)
    h = L.norm_apply(p["ln1"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    if cfg.use_mla:
        a = L.mla_apply(p["attn"], cfg, h, positions=positions,
                        cache=None if paged is not None else state,
                        cache_pos=cache_pos, paged=paged, plain=plain,
                        collector=collector, split=split, kind=kind)
    else:
        a = split.sum(lambda t: L.gqa_apply(
            split.take(p["attn"], kind, ("attn",), t), local, split.enter(h),
            positions=positions, pool=state if paged is not None else None,
            paged=paged, plain=plain, collector=collector,
            cache=None if paged is not None else state, cache_pos=cache_pos,
            mrope_position_ids=mrope_position_ids, out_float32=split.tensor))
    x = _resid(cfg, x, collector.tag("att_resid", a.to(x.dtype)))
    h = L.norm_apply(p["ln2"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    aux: dict = {}
    if kind == "moe":
        f, aux = L.moe_apply(p["mlp"], cfg, h, n_seq_groups=cfg.moe.seq_groups,
                             collector=collector, split=split)
    else:
        f = split.sum(lambda t: L.mlp_apply(
            split.take(p["mlp"], kind, ("mlp",), t), local, split.enter(h), collector,
            out_float32=split.tensor)).to(x.dtype)
    return _resid(cfg, x, collector.tag("ffn_resid", f)), aux


def _layers(cfg: ModelConfig, params: dict):
    """``(layer index, segment, group, block position, block kind, that
    layer's parameter views)`` over every segment."""
    layer = 0
    for i, (kinds, n) in enumerate(segment_layout(cfg)):
        seg = params[f"seg{i}"]
        for g in range(n):
            for j, kind in enumerate(kinds):
                yield layer, i, g, j, kind, _layer(seg[f"b{j}"], g)
                layer += 1


def _stack(rows: list[dict]) -> dict:
    """Per-group capture dicts -> one dict of leaves stacked on axis 0."""
    return {k: _stack([r[k] for r in rows]) if isinstance(v, dict)
            else torch.stack([r[k] for r in rows]) for k, v in rows[0].items()}


# the products remat "dots" keeps: matrix products without batch
# dimensions, as jax's ``dots_with_no_batch_dims_saveable`` keeps them (the
# projections and MLP products, and the ``mm`` that ``x @ w`` lowers to);
# ``bmm`` (attention's batched einsums) and K2, whose output is no aten op,
# are recomputed
_SAVED_PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.addmm)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The selective-checkpoint policy of remat ``"dots"``."""
    if op.overloadpacket in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(dots_policy)


def _embed_inputs(cfg: ModelConfig, params: dict, tokens: torch.Tensor | None,
                  embeds: torch.Tensor | None, dtype: torch.dtype,
                  split: Split | None = None) -> torch.Tensor:
    """The token embeddings (over the vocabulary slices of a tensor
    ``split``), or for an embeds arch the given ``embeds`` in the compute
    dtype, whole, scaled by ``scale_emb`` (JAX ``_embed_inputs``)."""
    if cfg.input_kind == "tokens":
        if tokens is None:
            raise ValueError(f"{cfg.name} takes token ids")
        return L.embed_apply(params, cfg, tokens, dtype, WHOLE if split is None else split)
    if embeds is None:
        raise ValueError(f"{cfg.name} takes input embeddings ({cfg.input_kind})")
    x = embeds.to(dtype)
    return x * cfg.scale_emb if cfg.scale_emb != 1.0 else x


def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor | None = None,  # [B, S] token ids
    *,
    embeds: torch.Tensor | None = None,  # [B, S, D] (an embeds arch)
    mrope_position_ids: torch.Tensor | None = None,  # [3, B, S] (M-RoPE)
    pool: dict | None = None,    # the serving pool (init_pool), updated in place
    cache: dict | None = None,   # dense cache (init_cache), updated in place
    cache_pos: torch.Tensor | int | None = None,  # [B] paged; int dense
    paged: PagedInfo | None = None,
    plain: bool = False,
    collector: Collector = NULL_COLLECTOR,
    split: Split | None = None,
) -> tuple[torch.Tensor, dict]:
    """Returns ``(hidden [B, S, D], aux)``.

    A token arch takes ``tokens``; an embeds arch (qwen2-vl) takes
    ``embeds`` in their place, and its attention rotates by M-RoPE over
    ``mrope_position_ids`` where given (1-D rope at the positions
    otherwise, which equals M-RoPE over three equal streams).  With
    ``pool`` (serving; batch row ``b`` is slot ``b`` of its state
    leaves), attention blocks write their new K/V into ``pool`` at per-slot
    positions ``cache_pos + arange(S)`` and read it through
    ``paged.tables``, recurrent blocks carry their slot rows; the pool is
    updated in place (the JAX package donates it to the same effect), and
    ``paged.plain`` selects the plain versions.  With ``cache`` (the dense
    cached path), positions are the int ``cache_pos + arange(S)``, each
    attention block writes its K/V into its layer of ``cache`` in place and
    attends with ``kv_len = cache_pos + S``, and each recurrent block
    carries its state in ``cache``.  With neither (training), positions are
    ``arange(S)``, attention
    is non-cached, ``plain`` selects the plain versions, and ``cfg.remat``
    decides what each layer keeps for the backward: ``"full"`` recomputes
    the layer in the backward (``jax.checkpoint`` with
    ``nothing_saveable``), ``"dots"`` keeps the outputs of its products
    without batch dimensions and recomputes the rest (:func:`dots_policy`),
    ``"none"`` keeps everything.  With a ``split`` (``models.split``;
    training only) the embedding gathers over its vocabulary slices and
    each layer runs its tensor slices, or its MoE router statistics over
    the data ranks.

    ``collector`` sees every tag of every forward (on the pool, an attention
    block with a live collector leaves the fused flash-prefill branch for
    the generic one, as in JAX); a layer's recompute in the backward
    perturbs alike and records nothing.
    A model with MoE layers reports in ``aux`` their ``aux_loss`` (summed
    over layers) and ``seg{i}_moe_drop_frac`` (the mean over a segment's
    layers), as JAX's does.
    ``aux["captures"]`` is ``{"seg{i}": {...}, "top": {...}}`` as JAX's:
    each segment's captures stacked over its groups (keys prefixed
    ``b{j}/`` where a group holds several blocks; the embeddings' ride
    ``seg0``, repeated over its groups), ``top`` the final hidden's; absent
    when nothing was captured.
    """
    dtype = getattr(torch, cfg.compute_dtype)
    x = _embed_inputs(cfg, params, tokens, embeds, dtype, split)
    B, S, _ = x.shape
    if pool is not None:
        plain = paged.plain
        remat = "none"
        positions = (cache_pos.long()[:, None]
                     + torch.arange(S, device=x.device)[None, :])
    else:
        if cfg.remat not in ("full", "dots", "none"):
            raise ValueError(f"unknown remat {cfg.remat!r}")
        if cache is not None:
            cache_pos = int(cache_pos)
        start = cache_pos or 0
        positions = (L.arange_positions(S, x.device) if start == 0
                     else torch.arange(start, start + S, device=x.device))
        remat = cfg.remat if cache is None and torch.is_grad_enabled() else "none"
    x = collector.tag("embeddings", x)
    layout = segment_layout(cfg)
    live = collector is not NULL_COLLECTOR
    # captures taken before the layers (embeddings) ride the first segment,
    # repeated over its groups, where JAX's scan body drains them
    before = collector.drain()
    groups: dict[int, list[dict]] = {}
    aux_loss, drop_fracs = None, {}
    for layer, i, g, j, kind, p in _layers(cfg, params):
        col = LayerScoped(collector, layer, f"seg{i}/b{j}") if live else collector
        blk_paged = None
        if pool is not None:
            blk_cache = pool[f"seg{i}"][f"b{j}"]
            if kind in _ATTENTION_KINDS:  # the layer-stacked pool, at layer g
                blk_paged = replace(paged, layer=g)
            else:                         # this layer's slot rows
                blk_cache = _layer(blk_cache, g)
        else:
            blk_cache = None if cache is None else _layer(cache[f"seg{i}"][f"b{j}"], g)
        args = (p, cfg, kind, x, positions, blk_paged, plain, col, blk_cache,
                cache_pos, mrope_position_ids, split)
        if remat == "full":
            x, blk_aux = checkpoint(_block, *args, use_reentrant=False)
        elif remat == "dots":
            x, blk_aux = checkpoint(_block, *args, use_reentrant=False,
                                    context_fn=_dots_contexts)
        else:
            x, blk_aux = _block(*args)
        if blk_aux:
            a = blk_aux["moe_aux_loss"]
            aux_loss = a if aux_loss is None else aux_loss + a
            drop_fracs.setdefault(i, []).append(blk_aux["moe_drop_frac"])
        if live:
            probes = col.drain()
            col.close()  # a recompute in the backward records nothing
            rows = groups.setdefault(i, [])
            if j == 0:
                rows.append(dict(before) if i == 0 else {})
            pre = f"b{j}/" if len(layout[i][0]) > 1 else ""
            rows[-1].update({pre + k: v for k, v in probes.items()})
    x = L.norm_apply(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps,
                     plain=plain)
    x = collector.tag("final_hidden", x)
    aux: dict = {}
    if aux_loss is not None:
        aux["aux_loss"] = aux_loss
        for i, fracs in drop_fracs.items():
            aux[f"seg{i}_moe_drop_frac"] = torch.stack(fracs).mean()
    captures = {f"seg{i}": _stack(rows) for i, rows in groups.items() if rows[0]}
    top = collector.drain()
    if top or captures:
        aux["captures"] = captures
        if top:
            captures["top"] = top
    return x, aux


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache: dict,
            collector: Collector = NULL_COLLECTOR, *,
            plain: bool = False) -> tuple[torch.Tensor, dict]:
    """JAX ``lm.prefill`` over the dense ``cache`` (:func:`init_cache`,
    filled in place): ``batch``'s prompts (``tokens``, or an embeds arch's
    ``embeds`` and ``mrope_position_ids``) from position 0.  Returns (the
    last position's logits ``[B, V]``, captures)."""
    hidden, aux = forward(cfg, params, batch.get("tokens"), embeds=batch.get("embeds"),
                          mrope_position_ids=batch.get("mrope_position_ids"),
                          cache=cache, cache_pos=0, plain=plain, collector=collector)
    return L.logits_fn(params, cfg, hidden[:, -1:])[:, 0], aux.get("captures", {})


def decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
                pos: int, collector: Collector = NULL_COLLECTOR, *,
                plain: bool = False) -> tuple[torch.Tensor, dict]:
    """JAX ``lm.decode_step`` at the shared ``pos`` over the dense cache (in
    place): token ids ``[B]`` (or ``[B, 1]``), or for an embeds arch one
    embedding row a sequence, ``[B, 1, D]`` (or ``[B, D]``), whose M-RoPE
    ids are ``pos`` in all three streams.  Returns (logits ``[B, V]``,
    captures)."""
    pos = int(pos)
    tok, embeds, ids = None, None, None
    if cfg.input_kind == "tokens":
        tok = tokens.reshape(-1, 1)
    else:
        embeds = tokens.reshape(tokens.shape[0], 1, -1)
        if cfg.input_kind == "embeds_mrope":
            ids = torch.full((3, embeds.shape[0], 1), pos, dtype=torch.int32,
                             device=embeds.device)
    hidden, aux = forward(cfg, params, tok, embeds=embeds, mrope_position_ids=ids,
                          cache=cache, cache_pos=pos, plain=plain, collector=collector)
    return L.logits_fn(params, cfg, hidden)[:, 0], aux.get("captures", {})


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            collector: Collector = NULL_COLLECTOR, *,
            plain: bool = False, split: Split | None = None
            ) -> tuple[torch.Tensor, dict]:
    """``(loss, metrics)`` as JAX ``lm.loss_fn``: the mean masked next-token
    cross entropy of ``batch`` (``tokens``, or ``embeds`` and
    ``mrope_position_ids`` for an embeds arch; ``targets``, optional
    ``loss_mask``) plus the MoE layers' auxiliary loss (zero for the other
    families); the metrics hold both, each MoE segment's
    ``seg{i}_moe_drop_frac`` and, with a live ``collector``, its
    ``captures`` (see :func:`forward`), on the device.  Under a ``split``
    the embedding, the blocks and the cross entropy run their tensor
    slices (the loss is the whole one on every tensor rank); over data
    ranks each MoE layer's auxiliary loss is this rank's part of the whole
    batch's (the data ranks' parts sum to it)."""
    split = WHOLE if split is None else split
    hidden, extra = forward(cfg, params, batch.get("tokens"),
                            embeds=batch.get("embeds"),
                            mrope_position_ids=batch.get("mrope_position_ids"),
                            plain=plain, collector=collector, split=split)
    total, count = L.chunked_xent(params, cfg, hidden, batch["targets"],
                                  batch.get("loss_mask"), split)
    ce = total / torch.clamp(count, min=1.0)
    aux = extra.pop("aux_loss", None)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux_loss": aux, **extra}
