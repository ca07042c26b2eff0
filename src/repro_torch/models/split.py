"""Megatron's tensor split of a model's blocks, and the data split of MoE's
router statistics: the object the forward carries and the table of the
leaves the split slices.

The JAX package reaches the same cells through GSPMD: its weight axes
``heads_w``, ``kv_heads_w``, ``mlp_w``, ``qkv``, ``expert_w`` and
``vocab_w`` go to the ``model`` axis (``parallel.profiles``).  The port
slices those dims on each tensor rank (:func:`tp_slices`, ``weights.shard_params``) and runs each
block over its rank's slices, with Megatron's conjugate pair on the
activations at the boundary between the whole region and the sliced one:
``copy_to_tp`` where a replicated tensor enters rank-local work,
``reduce_from_tp`` where the rank-local float32 partial products return to
the replicated residual stream.  The leaves then fall into three cases:

* a leaf used only before the boundary (a norm, MoE's router, RWKV-6's
  token-shift mix, MLA's latent ``wdkv`` and ``kv_norm`` and its roped key
  ``wkr``, whose outputs enter the slices) gets a whole gradient, the same
  on every rank, and is not summed;
* a sliced leaf gets its own slice's gradient;
* a leaf kept whole but used inside the sliced region (qk_norm's scales,
  RWKV-6's decay and bonus, Griffin's single kv head) enters through
  ``copy_to_tp`` itself, so its partial gradients sum over the ranks.

The leaves the JAX rules put on ``model`` that the split keeps whole are
:data:`KEPT_WHOLE`, each with its reason (ROADMAP's known difference P19).

The vocabulary is Megatron's vocab-parallel pair: tensor rank ``r`` of
``tp`` owns rows ``[r Vp/tp, (r+1) Vp/tp)`` of the padded vocabulary ``Vp``,
of the embedding and of the head's columns (tied, the one slice serves
both).  The embedding gathers its rows and zeros for the other tokens, and
the ranks' parts are summed (:meth:`Split.sum`: one term is nonzero, so
the sum is exact); the cross entropy (``layers.chunked_xent``) takes each
row's max over the ranks (:meth:`Split.max`), then the sum of its
exponentials and the target's logit.  Inside a pipeline (pp > 1) the
embedding and the head run whole on stage 0, as JAX's pipeline runs them
outside its stages (:data:`PIPELINE_WHOLE`).

A :class:`Split` rides ``lm.loss_fn`` / ``lm.forward`` down to the blocks
as MegaScope's collector does; None is the fused path.  In a world it
holds the ``model`` axis' process group, and each rank computes its own
slice.  Without a group it runs every slice in this process from the whole
tree and sums their products (the fused arithmetic with the split's order
of sums: the reference a world's run is held to).  Under data parallelism
over MoE layers it also holds the ``data`` group: each rank's router
counts are summed over it, and its load-balance and z-loss terms are
partial sums over its rows that add up to the whole batch's.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig

# the weight axes the split slices, by family (at most one a leaf)
_SLICED = {
    "dense": ("heads_w", "kv_heads_w", "mlp_w", "vocab_w"),
    "moe": ("heads_w", "kv_heads_w", "mlp_w", "expert_w", "vocab_w"),
    "rwkv6": ("qkv", "mlp_w", "vocab_w"),
    "griffin": ("heads_w", "kv_heads_w", "qkv", "mlp_w", "vocab_w"),
    "encdec": ("heads_w", "kv_heads_w", "mlp_w", "vocab_w"),
}

# leaves the JAX package's rules put on ``model`` (under ``fsdp_cp``) that
# the split keeps whole on every rank, matched on the end of their path
KEPT_WHOLE = {
    ("q_norm",): "head_dim_w: a per-head-dim scale every local head uses; it "
                 "enters through copy_to_tp and its gradient is summed",
    ("k_norm",): "head_dim_w: as q_norm",
    ("mix", "wk"): "Griffin's single kv head (MQA) does not divide tp; JAX "
                   "then puts head_dim_w on model.  Every rank keeps the head "
                   "whole, it enters through copy_to_tp, its gradient is summed",
    ("mix", "wv"): "as Griffin's wk",
    ("ffn", "w_r"): "RWKV-6's channel-mix gate multiplies the summed kv: kept "
                    "whole outside the split, its gradient whole on every rank "
                    "(no all-gather of the gate)",
    ("mix", "w_x"): "Griffin's recurrent input and its conv run whole (no "
                    "all-gather of the conv output): the RG-LRU gates read "
                    "every channel of it, which enters through copy_to_tp",
    ("mix", "conv_w"): "as w_x",
    ("mix", "conv_b"): "as w_x",
    ("attn", "wkr"): "head_dim_w: the one roped key every local head reads "
                     "(MLA's kpe, broadcast over the heads); computed whole "
                     "before the boundary and entered",
}

# leaves the split slices at pp = 1 that a pipeline keeps whole: JAX's
# pipeline embeds and takes the loss outside its stages, replicated
# (``repro.models.pipeline``, under ``axis_rules(None)``); here stage 0
PIPELINE_WHOLE = {
    ("embedding",): "vocab_w: stage 0 embeds the whole batch, whole",
    ("unembed",): "vocab_w: stage 0's cross entropy runs whole",
}


def _is_axes(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(a, (str, type(None))) for a in t)


def _flat(tree: dict, path: tuple = ()):
    for k, v in tree.items():
        if _is_axes(v):
            yield (*path, k), v
        else:
            yield from _flat(v, (*path, k))


def unsupported(cfg: ModelConfig, tp: int) -> str | None:
    """What of ``cfg`` the tensor split at pp = 1 does not run (ROADMAP
    item 8c), or None."""
    if tp > 1 and cfg.family not in _SLICED:
        return f"{cfg.name}: tensor parallelism over family {cfg.family!r}"
    return None


def validate(cfg: ModelConfig, tp: int, pp: int = 1) -> None:
    """Raise unless ``cfg``'s blocks split over ``tp`` tensor ranks:
    ``NotImplementedError`` naming ROADMAP item 8c for what is not ported
    (:func:`unsupported`), ``ValueError`` for a width that does not divide:
    the heads (RWKV-6's WKV heads), Griffin's recurrent width, the ffn
    width, the experts and the shared experts' width, the kv heads unless
    there is one (kept whole), and at ``pp = 1`` the padded vocabulary."""
    why = unsupported(cfg, tp)
    if why is not None:
        raise NotImplementedError(f"{why} is ported in a later slice "
                                  "(ROADMAP queue 1, item 8c)")
    if tp <= 1:
        return
    widths = {"heads": cfg.num_heads, "d_ff": cfg.d_ff}
    if cfg.family in ("dense", "moe", "griffin", "encdec") and cfg.num_kv_heads != 1:
        widths["kv_heads"] = cfg.num_kv_heads
    if cfg.family == "griffin":
        widths["lru_width"] = cfg.lru_width
    if cfg.family == "moe":
        widths["experts"] = cfg.moe.num_experts
        if cfg.moe.num_shared_experts:
            widths["shared_d_ff"] = cfg.moe.num_shared_experts * cfg.moe.expert_d_ff
    if pp == 1:
        widths["padded_vocab"] = cfg.padded_vocab
    bad = {k: v for k, v in widths.items() if v % tp}
    if bad:
        raise ValueError(f"{cfg.name}: " + "/".join(f"{k}={v}" for k, v in bad.items())
                         + f" must divide by tp={tp} for the tensor split")


def tp_slices(cfg: ModelConfig, tp: int, pp: int = 1) -> dict[tuple[str, ...], int]:
    """``{leaf path: dim}`` of every leaf of ``cfg``'s tree (the family's
    ``param_axes``) whose dim the tensor split over ``tp`` slices in a run
    of ``pp`` pipeline stages: every segment's leaves (the encoder's and
    the decoder's) and those outside them (the embedding and the head), on
    the family's sliced axes, less :data:`KEPT_WHOLE`'s and, at ``pp > 1``,
    :data:`PIPELINE_WHOLE`'s."""
    if tp <= 1:
        return {}
    from repro_torch.models.model import get_model

    axes = get_model(cfg).param_axes(cfg)
    sliced = set(_SLICED[cfg.family])
    if cfg.num_kv_heads == 1:
        sliced.discard("kv_heads_w")
    whole = {**KEPT_WHOLE, **(PIPELINE_WHOLE if pp > 1 else {})}
    out = {}
    for path, ax in _flat(axes):
        if any(path[-len(k):] == k for k in whole):
            continue
        dims = [d for d, a in enumerate(ax) if a in sliced]
        if dims:
            out[path] = dims[0]
    return out


def local_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    """A tensor rank's view of ``cfg``: heads (MLA's too), kv heads (one is
    kept), the ffn width and Griffin's recurrent width divided by ``tp``
    (GQA's grouping ratio is kept, so each local q head reads its kv
    head)."""
    kw = dict(num_heads=cfg.num_heads // tp, d_ff=cfg.d_ff // tp)
    if cfg.num_kv_heads != 1:
        kw["num_kv_heads"] = cfg.num_kv_heads // tp
    if cfg.family == "griffin":
        from dataclasses import replace

        kw["griffin"] = replace(cfg.griffin, lru_width=cfg.lru_width // tp)
    return cfg.replace(**kw)


@dataclass(frozen=True)
class Split:
    """The split a forward runs under (:func:`make_split`).  ``tp`` tensor
    slices; ``group`` the ``model`` axis' process group and ``rank`` this
    process's slice, or no group: every slice here, from the whole tree.
    ``data_group`` and ``dp``: MoE's router statistics summed over the data
    ranks.  ``dims``: ``{(block kind, *path in the block): dim}`` of the
    sliced leaves, the encoder-decoder's layers of kind ``"encoder"`` and
    ``"decoder"``; ``local``: :func:`local_cfg`.  At ``tp = 1`` (:data:`WHOLE`)
    every method is the identity, so a block's one body runs fused:
    ``cut``, ``narrow``, ``enter`` and ``take`` return what they are given,
    ``sum`` and ``max`` are ``part(0)``, ``slices`` is ``(0,)``,
    ``vocab_range`` the whole padded vocabulary and ``out`` the product in
    the compute dtype."""

    tp: int = 1
    group: Any = None
    rank: int = 0
    data_group: Any = None
    dp: int = 1
    dims: dict = field(default_factory=dict, compare=False)
    local: ModelConfig | None = None

    @property
    def tensor(self) -> bool:
        return self.tp > 1

    @property
    def slices(self) -> tuple[int, ...]:
        """The slices this process computes: its rank's in a world, every
        one without a group."""
        return tuple(range(self.tp)) if self.group is None else (self.rank,)

    def vocab_range(self, cfg: ModelConfig, t: int) -> tuple[int, int]:
        """Slice ``t``'s rows ``[lo, hi)`` of the padded vocabulary."""
        n = cfg.padded_vocab // self.tp
        return t * n, (t + 1) * n

    def cfg(self, cfg: ModelConfig) -> ModelConfig:
        """A slice's view of ``cfg`` (:func:`local_cfg`), ``cfg`` at tp 1."""
        return self.local if self.tensor else cfg

    def cut(self, leaf: torch.Tensor, dim: int, t: int) -> torch.Tensor:
        """Slice ``t`` of a leaf the table slices along ``dim``: in a world
        the leaf is already this rank's slice."""
        return leaf if self.group is not None else self.narrow(leaf, dim, t)

    def narrow(self, x: torch.Tensor, dim: int, t: int) -> torch.Tensor:
        """Slice ``t`` of a whole tensor along ``dim``."""
        if not self.tensor:
            return x
        n = x.shape[dim] // self.tp
        return x.narrow(dim, t * n, n)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated tensor entering a slice's work: ``copy_to_tp`` in a
        world; here a view of its own, so its gradient sums within the slice
        first, as on its rank."""
        if not self.tensor:
            return x
        if self.group is None:
            return x.view_as(x)
        from repro_torch.parallel.dist import copy_to_tp

        return copy_to_tp(x, self.group)

    def sum(self, part: Callable[[int], torch.Tensor]) -> torch.Tensor:
        """The float32 sum of ``part(t)`` over the slices: ``reduce_from_tp``
        of this rank's in a world."""
        if not self.tensor:
            return part(0)
        if self.group is None:
            parts = [part(t) for t in range(self.tp)]
            return sum(parts[1:], parts[0])
        from repro_torch.parallel.dist import reduce_from_tp

        return reduce_from_tp(part(self.rank), self.group)

    def max(self, part: Callable[[int], torch.Tensor]) -> torch.Tensor:
        """The elementwise maximum of ``part(t)`` over the slices (no
        gradient): a float32 all-reduce MAX of this rank's in a world."""
        if not self.tensor:
            return part(0)
        if self.group is None:
            parts = [part(t) for t in range(self.tp)]
            return functools.reduce(torch.maximum, parts[1:], parts[0])
        from repro_torch.parallel.dist import all_reduce_max

        return all_reduce_max(part(self.rank), self.group)

    def out(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """A slice's product returning to the residual stream, ``a [..., K]
        @ w [K, N]`` in ``a``'s dtype: under the split its float32 result
        (``layers.matmul_float32``), which :meth:`sum` adds over the slices
        and the caller rounds once, as the fused product rounds."""
        w = w.to(a.dtype)
        if not self.tensor:
            return a @ w
        from repro_torch.models.layers import matmul_float32

        return matmul_float32(a.reshape(-1, a.shape[-1]), w).reshape(*a.shape[:-1], -1)

    def take(self, p: dict, kind: str, sub: tuple[str, ...], t: int) -> dict:
        """Slice ``t``'s leaves of the sub-block ``p`` (at ``sub`` in a block
        of ``kind``) used wholly inside the sliced region: each sliced leaf
        cut, every other one entered."""
        if not self.tensor:
            return p

        def walk(tree, path):
            return {k: walk(v, (*path, k)) if isinstance(v, dict)
                    else self.cut(v, self.dims[(kind, *path, k)], t)
                    if (kind, *path, k) in self.dims else self.enter(v)
                    for k, v in tree.items()}

        return walk(p, sub)

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data ranks (no gradient)."""
        if self.data_group is None:
            return x
        import torch.distributed as dist

        x = x.detach().clone()
        dist.all_reduce(x, group=self.data_group)
        return x


WHOLE = Split()
"""The fused path's split: one slice, the whole tree."""


def make_split(cfg: ModelConfig, tp: int, *, group=None, rank: int = 0,
               data_group=None, dp: int = 1, pp: int = 1) -> Split:
    """The :class:`Split` of ``cfg`` over ``tp`` tensor slices (validated;
    in a run of ``pp`` pipeline stages) and ``dp`` data ranks."""
    validate(cfg, tp, pp)
    dims: dict = {}
    if tp > 1 and cfg.family == "encdec":
        for path, d in tp_slices(cfg, tp).items():
            if path[0] in ("encoder", "decoder"):  # the layer axis dropped
                dims[path] = d - 1
    elif tp > 1:
        from repro_torch.models import lm

        kinds = {f"seg{i}": ks for i, (ks, _) in enumerate(lm.segment_layout(cfg))}
        for path, d in tp_slices(cfg, tp).items():
            if path[0] in kinds:  # seg{i}/b{j}/...: the layer axis dropped
                dims[(kinds[path[0]][int(path[1][1:])], *path[2:])] = d - 1
    return Split(tp=tp, group=group, rank=rank, data_group=data_group, dp=dp,
                 dims=dims, local=local_cfg(cfg, tp) if tp > 1 else cfg)
