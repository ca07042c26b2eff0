"""Meta-device stand-ins and per-device shard shapes for every (architecture x
shape) dryrun cell, counterpart of ``repro.launch.specs``.  Nothing is
allocated: every tensor lies on the meta device, which keeps shapes and
dtypes only.

A :class:`Cell` holds the step the card would run (the train step, the
dense-cache prefill or decode), its arguments as meta tensors, the logical
axes of every argument leaf, the arguments the step updates in place (the
JAX cell donates them) and the cell's kind and tokens.  The per-device
shard shapes come from the port's ``parallel.profiles.rules_for`` and
``parallel.sharding.logical_to_spec`` on a mesh given by its axis sizes.

JAX's ``probe_pair`` is not ported: it exists because XLA's cost analysis
counts a scanned layer's body once, so the JAX dryrun compiles two shallow
unrolled probes and extrapolates; the port's eager step runs every layer,
and its meta pass counts each of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import get_model
from repro_torch.parallel.profiles import rules_for
from repro_torch.parallel.sharding import logical_to_spec

META = torch.device("meta")

_BATCH_AXES: dict[str, tuple[str | None, ...]] = {
    "tokens": ("batch", "seq_act"),
    "targets": ("batch", "seq_act"),
    "loss_mask": ("batch", "seq_act"),
    "embeds": ("batch", "seq_act", "embed_act"),
    "mrope_position_ids": (None, "batch", "seq_act"),
}

# the dense cache's leaves by name (JAX ``serve.engine._CACHE_AXES``); a
# stacked leaf leads with "layers"
_CACHE_AXES: dict[str, tuple[str | None, ...]] = {
    "k": ("batch", "kv_time", "kv_heads_act", "head_dim_act"),
    "v": ("batch", "kv_time", "kv_heads_act", "head_dim_act"),
    "ck": ("batch", "kv_time", "kv_heads_act", "head_dim_act"),
    "cv": ("batch", "kv_time", "kv_heads_act", "head_dim_act"),
    "ckv": ("batch", "kv_time", "kv_lora_act"),
    "kpe": ("batch", "kv_time", "head_dim_act"),
    "wkv": ("batch", "heads_act", "state", "state"),
    "x_prev": ("batch", "embed_act"),
    "conv": ("batch", "conv", "mlp_act"),
    "h": ("batch", "mlp_act"),
}


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, B: int, S: int) -> dict:
    out = {"targets": _sds((B, S), torch.int32)}
    if cfg.input_kind == "tokens":
        out["tokens"] = _sds((B, S), torch.int32)
    else:
        out["embeds"] = _sds((B, S, cfg.d_model), torch.bfloat16)
        if cfg.family == "encdec":
            out["tokens"] = _sds((B, S), torch.int32)
        if cfg.input_kind == "embeds_mrope":
            out["mrope_position_ids"] = _sds((3, B, S), torch.int32)
    return out


def cache_axes(cache: dict) -> dict:
    """The logical axes of a dense cache's leaves, by leaf name."""
    return {k: cache_axes(v) if isinstance(v, dict)
            else ("layers",) * (v.dim() - len(_CACHE_AXES[k])) + _CACHE_AXES[k]
            for k, v in cache.items()}


@dataclass
class Cell:
    """One (arch x shape) cell: ``step(*args)`` runs it on the meta device.
    ``axes`` mirrors ``args`` with each leaf's logical axes (an int leaf,
    AdamW's step counter, has none); ``donate_argnums`` are the arguments
    the step updates in place; ``meta`` holds the cell's ``tokens``, its
    sharding ``rules`` and its ``mesh`` (axis sizes, or None)."""
    step: Callable
    args: tuple
    axes: tuple
    donate_argnums: tuple[int, ...]
    kind: str
    meta: dict


def leaves(tree: Any) -> list:
    """The leaves of nested dicts, lists, tuples and dataclasses, in order."""
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [x for f in tree.__dataclass_fields__ for x in leaves(getattr(tree, f))]
    return [tree]


def _is_axes(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(a, (str, type(None))) for a in t)


def axes_leaves(tree: Any) -> list:
    """:func:`leaves` of a tree of logical-axes tuples (each tuple a leaf)."""
    if _is_axes(tree) or tree is None:
        return [tree]
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in axes_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in axes_leaves(v)]
    return [x for f in tree.__dataclass_fields__ for x in axes_leaves(getattr(tree, f))]


def shard_shape(shape: tuple[int, ...], axes, mesh: Mapping[str, int],
                rules) -> tuple[int, ...]:
    """One device's part of a leaf of ``shape`` under ``rules`` on a mesh
    of the given axis sizes."""
    spec = logical_to_spec(axes, shape, mesh, rules)
    out = list(shape)
    for i, part in enumerate(spec):
        for ax in (part,) if isinstance(part, str) else (part or ()):
            out[i] //= mesh[ax]
    return tuple(out)


def bytes_per_device(cell: Cell) -> int:
    """The cell's argument bytes on one device of its mesh (None: one
    device holds everything)."""
    mesh = cell.meta["mesh"]
    total = 0
    for t, ax in zip(leaves(cell.args), axes_leaves(cell.axes)):
        if not isinstance(t, torch.Tensor):
            continue
        shape = tuple(t.shape) if mesh is None else shard_shape(
            tuple(t.shape), ax, mesh, cell.meta["rules"])
        n = 1
        for d in shape:
            n *= d
        total += n * t.element_size()
    return total


def _cache(cfg: ModelConfig, B: int, S: int) -> dict:
    m = get_model(cfg)
    if cfg.family == "encdec":
        return m.init_cache(cfg, B, S, S, device=META)
    return m.init_cache(cfg, B, S, device=META)


def input_specs(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh: Mapping[str, int] | None = None,
    *,
    profile: str | None = None,
    grad_accum: int = 1,
    ocfg=None,
) -> Cell:
    """The step and meta stand-ins of a cell: (train state, batch) for a
    train cell, (params, batch, cache) for prefill, (params, cache, tokens,
    pos) for decode (one new token a row against a cache of ``seq_len``, at
    its last position).  ``mesh`` (axis sizes) is where
    :func:`bytes_per_device` shards the arguments under the profile's
    rules."""
    from repro_torch.train.optim import OptimizerConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    rules = rules_for(cfg, shape.kind, profile)
    m = get_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    p_axes = m.param_axes(cfg)

    if shape.kind == "train":
        state = init_train_state(cfg, device=META)
        step = make_train_step(cfg, ocfg or OptimizerConfig(), grad_accum=grad_accum)
        batch = train_batch_specs(cfg, B, S)
        state_axes = {"params": p_axes, "master": p_axes,
                      "opt": {"m": p_axes, "v": p_axes, "step": None}}
        return Cell(
            step=step, args=(state, batch),
            axes=(state_axes, {k: _BATCH_AXES[k] for k in batch}),
            donate_argnums=(0,), kind="train",
            meta={"tokens": B * S, "rules": rules, "mesh": mesh},
        )

    # serving steps hold the weights as the servers cast them (norm scales
    # and the like stay float32)
    params = m.init(cfg, device=META, dtype=getattr(torch, cfg.compute_dtype))
    cache = _cache(cfg, B, S)
    c_axes = cache_axes(cache)

    if shape.kind == "prefill":
        batch = train_batch_specs(cfg, B, S)
        batch.pop("targets")

        @torch.inference_mode()
        def prefill(params, batch, cache):
            return m.prefill(cfg, params, batch, cache)

        return Cell(
            step=prefill, args=(params, batch, cache),
            axes=(p_axes, {k: _BATCH_AXES[k] for k in batch}, c_axes),
            donate_argnums=(2,), kind="prefill",
            meta={"tokens": B * S, "rules": rules, "mesh": mesh},
        )

    if cfg.input_kind != "tokens" and cfg.family != "encdec":
        raise ValueError(
            f"{cfg.name}: the port's decode step takes token ids; an "
            f"{cfg.input_kind} arch decodes from embeddings ([B, 1, d_model], "
            "the JAX cell's input), which models.lm.decode_step does not take")

    @torch.inference_mode()
    def decode(params, cache, tokens, pos):
        return m.decode_step(cfg, params, cache, tokens, pos)

    return Cell(
        step=decode, args=(params, cache, _sds((B,), torch.int32), S - 1),
        axes=(p_axes, c_axes, ("batch",), None),
        donate_argnums=(1,), kind="decode",
        meta={"tokens": B, "rules": rules, "mesh": mesh},
    )


