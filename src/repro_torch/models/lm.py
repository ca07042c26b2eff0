"""Decoder-only LM assembly for the dense GQA family, in PyTorch.

Counterpart of ``repro.models.lm``.  Parameters keep the JAX tree: per-layer
leaves of segment ``i`` are stacked ``[n_layers, ...]`` under
``params["seg{i}"]["b0"]``.  ``forward`` is a Python loop over layers that
indexes each layer's parameters and its layer of the stacked KV pool in place
(``[n_layers, num_blocks, bs, K, dh]``), never a sliced copy.  Only the paged
serving forward is ported in this slice; the training forward and the dense
cached path arrive with later slices.
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention.ops import PagedInfo
from repro_torch.models import layers as L

# leaves that enter float32 norm math uncast; every other leaf is cast to the
# compute dtype at use, so a copy cast once at load gives the same values
_NORM_LEAVES = ("scale", "q_norm", "k_norm")


def segment_layout(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    """Returns [(block_kinds_per_group, n_groups), ...] covering all layers."""
    if cfg.family != "dense" or cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is ported in a later slice "
            "(ROADMAP queue 1); this slice serves dense GQA models")
    return [(("dense",), cfg.num_layers)]


def init(cfg: ModelConfig, *, seed: int = 0, device: str = "cuda") -> dict:
    """Random float32 parameters from ``seed``, built on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = L.ParamBuilder(gen, dev)
    L.embed_init(b, cfg)
    L.norm_init(b, "final_norm", cfg.d_model, cfg.norm_kind)
    for i, (kinds, n) in enumerate(segment_layout(cfg)):
        seg = b.sub(f"seg{i}", lead=(n,))
        for j, _ in enumerate(kinds):
            blk = seg.sub(f"b{j}")
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


def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,        # [B, S] token ids
    *,
    pool: dict,                  # layer-stacked KV pool, updated in place
    cache_pos: torch.Tensor,     # [B] per-slot write position of token 0
    paged: PagedInfo,
) -> torch.Tensor:
    """Returns the final hidden states ``[B, S, D]``.

    Attention blocks write their new K/V into ``pool`` at per-slot positions
    ``cache_pos + arange(S)`` and read it through ``paged.tables``.  The pool
    is updated in place; the JAX package donates it to the same effect.
    """
    if cfg.input_kind != "tokens":
        raise NotImplementedError(f"{cfg.name}: embeds inputs are a later slice")
    dtype = getattr(torch, cfg.compute_dtype)
    x = L.embed_apply(params, cfg, tokens, dtype)
    B, S, _ = x.shape
    positions = cache_pos.long()[:, None] + torch.arange(S, device=x.device)[None, :]
    layer = 0
    for i, (kinds, n) in enumerate(segment_layout(cfg)):
        seg = params[f"seg{i}"]
        for g in range(n):
            for j, _ in enumerate(kinds):
                p = _layer(seg[f"b{j}"], g)
                h = L.norm_apply(p["ln1"], x, cfg.norm_kind, cfg.norm_eps)
                a = L.gqa_apply(p["attn"], cfg, h, positions=positions,
                                pool=pool, paged=replace(paged, layer=layer))
                x = _resid(cfg, x, a)
                h = L.norm_apply(p["ln2"], x, cfg.norm_kind, cfg.norm_eps)
                x = _resid(cfg, x, L.mlp_apply(p["mlp"], cfg, h))
                layer += 1
    return L.norm_apply(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
