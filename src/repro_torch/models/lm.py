"""Decoder-only LM assembly for the dense GQA, RWKV-6 and Griffin families,
in PyTorch.

Counterpart of ``repro.models.lm``.  Parameters keep the JAX tree: per-layer
leaves of segment ``i`` are stacked ``[n_layers, ...]`` under
``params["seg{i}"]["b0"]``.  ``forward`` is a Python loop over layers that
indexes each layer's parameters and its layer of the stacked KV pool in place
(``[n_layers, num_blocks, bs, K, dh]``), never a sliced copy.  Two forwards
are ported: the paged serving forward (``pool`` given; dense family only)
and the training forward (``pool=None``, the ``cache is None`` path of JAX
``lm.forward``) that :func:`loss_fn` differentiates, with ``cfg.remat`` as
``torch.utils.checkpoint`` around each layer.  The dense cached path and
recurrent serving arrive with later slices.
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention.ops import PagedInfo
from repro_torch.models import griffin as gf
from repro_torch.models import layers as L
from repro_torch.models import rwkv as rk

# leaves that enter float32 norm math uncast; every other leaf is cast to the
# compute dtype at use, so a copy cast once at load gives the same values
_NORM_LEAVES = ("scale", "q_norm", "k_norm")


def segment_layout(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    """Returns [(block_kinds_per_group, n_groups), ...] covering all layers."""
    if cfg.family == "rwkv6":
        return [(("rwkv",), cfg.num_layers)]
    if cfg.family == "griffin":  # pattern groups, then the remainder
        pat = cfg.griffin.pattern
        n_full, rem = divmod(cfg.num_layers, len(pat))
        return ([(pat, n_full)] if n_full else []) + (
            [(pat[:rem], 1)] if rem else [])
    if cfg.family != "dense" or cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is ported in a later slice "
            "(ROADMAP queue 1); dense GQA, RWKV-6 and Griffin models are ported")
    return [(("dense",), cfg.num_layers)]


_SERVING_SLICE = {"rwkv6": "RWKV serving slice", "griffin": "Griffin serving slice"}


def require_paged(cfg: ModelConfig) -> None:
    """Serving runs over the paged KV pool, which only the dense family has
    in the port so far."""
    segment_layout(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: serving the {cfg.family} family (a carried "
            "recurrent state, pow2 segment prefill) is ported with the "
            f"{_SERVING_SLICE[cfg.family]} (ROADMAP queue 1, item 13)")


def init(cfg: ModelConfig, *, seed: int = 0, device: str = "cuda") -> dict:
    """Random float32 parameters from ``seed``, built on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = L.ParamBuilder(gen, dev)
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
            L.gqa_init(blk.sub("attn"), cfg)
            L.mlp_init(blk.sub("mlp"), cfg)
    return b.params


def cast_params(params: dict, dtype: torch.dtype, device: torch.device) -> dict:
    """A copy on ``device`` with every matrix and bias in ``dtype`` (norm
    scales stay float32): what ``forward`` would cast to at each use."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = cast_params(v, dtype, device)
        else:
            out[k] = v.to(device=device,
                          dtype=torch.float32 if k in _NORM_LEAVES else dtype)
    return out


def init_pool(cfg: ModelConfig, num_blocks: int, block_size: int,
              device: torch.device) -> dict:
    """The layer-stacked bfloat16 KV pool ``{"k", "v"}``, each
    ``[n_layers, num_blocks, block_size, K, dh]``; block 0 is the null block."""
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    return {name: torch.zeros(shape, dtype=torch.bfloat16, device=device)
            for name in ("k", "v")}


def _layer(tree: dict, g: int) -> dict:
    return {k: _layer(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


def _resid(cfg: ModelConfig, x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    if cfg.scale_depth:
        return x + delta * (cfg.scale_depth / math.sqrt(cfg.num_layers))
    return x + delta


def _block(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
           positions: torch.Tensor, pool: dict | None, paged: PagedInfo | None,
           plain: bool) -> torch.Tensor:
    """One decoder layer (``_block_apply``'s rwkv, griffin and dense
    branches)."""
    if kind == "rwkv":
        return rk.rwkv_block_apply(p, cfg, x, plain=plain)[0]
    if kind in ("rec", "attn"):
        return gf.griffin_block_apply(p, cfg, kind, x, positions=positions,
                                      plain=plain)[0]
    h = L.norm_apply(p["ln1"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    a = L.gqa_apply(p["attn"], cfg, h, positions=positions, pool=pool,
                    paged=paged, plain=plain)
    x = _resid(cfg, x, a)
    h = L.norm_apply(p["ln2"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    return _resid(cfg, x, L.mlp_apply(p["mlp"], cfg, h))


def _layers(cfg: ModelConfig, params: dict):
    """``(layer index, block kind, that layer's parameter views)`` over every
    segment."""
    layer = 0
    for i, (kinds, n) in enumerate(segment_layout(cfg)):
        seg = params[f"seg{i}"]
        for g in range(n):
            for j, kind in enumerate(kinds):
                yield layer, kind, _layer(seg[f"b{j}"], g)
                layer += 1


def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,        # [B, S] token ids
    *,
    pool: dict | None = None,    # layer-stacked KV pool, updated in place
    cache_pos: torch.Tensor | None = None,  # [B] per-slot write position
    paged: PagedInfo | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """Returns the final hidden states ``[B, S, D]``.

    With ``pool`` (serving), attention blocks write their new K/V into
    ``pool`` at per-slot positions ``cache_pos + arange(S)`` and read it
    through ``paged.tables``; the pool is updated in place (the JAX package
    donates it to the same effect), and ``paged.plain`` selects the plain
    versions.  Without (training), positions are ``arange(S)``, attention
    is non-cached, ``plain`` selects the plain versions, and ``cfg.remat``
    decides what each layer keeps for the backward: ``"full"`` recomputes
    the layer in the backward (``jax.checkpoint`` with
    ``nothing_saveable``), ``"none"`` keeps everything.
    """
    if cfg.input_kind != "tokens":
        raise NotImplementedError(f"{cfg.name}: embeds inputs are a later slice")
    dtype = getattr(torch, cfg.compute_dtype)
    x = L.embed_apply(params, cfg, tokens, dtype)
    B, S, _ = x.shape
    if pool is not None:
        require_paged(cfg)
        plain = paged.plain
        positions = (cache_pos.long()[:, None]
                     + torch.arange(S, device=x.device)[None, :])
        for layer, kind, p in _layers(cfg, params):
            x = _block(p, cfg, kind, x, positions, pool,
                       replace(paged, layer=layer), plain)
    else:
        if cfg.remat == "dots":
            raise NotImplementedError(
                'remat="dots" (save the matmul outputs) is ported in a later '
                'slice (ROADMAP queue 1, item 4); use "full" or "none"')
        if cfg.remat not in ("full", "none"):
            raise ValueError(f"unknown remat {cfg.remat!r}")
        positions = torch.arange(S, device=x.device)
        for _, kind, p in _layers(cfg, params):
            if cfg.remat == "full" and torch.is_grad_enabled():
                x = checkpoint(_block, p, cfg, kind, x, positions, None, None,
                               plain, use_reentrant=False)
            else:
                x = _block(p, cfg, kind, x, positions, None, None, plain)
    return L.norm_apply(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps,
                        plain=plain)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            plain: bool = False) -> tuple[torch.Tensor, dict]:
    """``(loss, metrics)`` as JAX ``lm.loss_fn``: the mean masked next-token
    cross entropy of ``batch`` (``tokens``, ``targets``, optional
    ``loss_mask``); the ported families have no auxiliary loss."""
    hidden = forward(cfg, params, batch["tokens"], plain=plain)
    total, count = L.chunked_xent(params, cfg, hidden, batch["targets"],
                                  batch.get("loss_mask"))
    ce = total / torch.clamp(count, min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux_loss": aux}
