"""Logical-axis sharding rules (MaxText-style), copied from
``repro.parallel.sharding``.

Every weight and activation of the model is annotated with *logical* axis
names (``"batch"``, ``"embed_w"``, ``"heads_w"``, ...: ``lm.param_axes``
holds the weights').  A per-run rule table maps logical names onto mesh
axes (``"pod"``, ``"data"``, ``"model"``, ``"stage"``).  Resolution is
size-aware: a mesh axis that does not evenly divide the array dimension is
dropped (the dimension stays replicated), so one rule table serves
architectures whose head counts or widths do not divide the tensor degree.

A *spec* here is a tuple with one entry a dimension: ``None``
(replicated), a mesh-axis name, or a tuple of them (trailing ``None``\\ s
stripped, as ``PartitionSpec`` strips them).  A *mesh* is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions
(``launch.mesh``) or a plain ``{axis: size}`` mapping, which resolves the
rules without any process holding the ranks (a mesh larger than the world).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Mapping, Sequence

import torch

# logical axis -> tuple of mesh axes (in nesting order) or None (replicated)
AxisRules = Mapping[str, tuple[str, ...] | None]
Spec = tuple[str | tuple[str, ...] | None, ...]

# Default rules: FSDP ("data") x TP ("model") with pure-DP "pod" axis.
#   - batch is sharded over pod+data (data parallelism)
#   - model-parallel width dims (heads / mlp / vocab) go to "model"
#   - "embed" on weights goes to "data": combined with the model axis on the
#     other dim this gives 2-D (ZeRO-3 / FSDP + TP) weight sharding
#   - sequence parallelism for activations between blocks uses "seq_act"
DEFAULT_RULES: dict[str, tuple[str, ...] | None] = {
    "batch": ("pod", "data"),
    "seq": None,              # sequence dim of activations inside attention
    "seq_act": None,          # sequence dim of residual-stream activations
    "embed": ("data",),       # weight embed dim -> FSDP
    "embed_act": None,        # activation embed dim
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "qkv": ("model",),        # fused qkv output dim
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "expert_mlp": None,
    "kv_lora": None,
    "conv": None,
    "state": None,
    "layers": None,           # stacked-layer leading axis (scanned over)
    "stack": None,
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: AxisRules | None = None


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh, rules: AxisRules | None = None):
    """Context manager installing the (mesh, logical-axis rules) pair.

    With no mesh installed every sharding annotation is a no-op, so model
    code runs unchanged in one process."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = dict(rules) if rules is not None else dict(DEFAULT_RULES)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh_and_rules():
    return _CTX.mesh, _CTX.rules


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` of a named ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a sharding mesh needs named dimensions")
    return dict(zip(names, mesh.mesh.shape))


def _resolve_axes(
    logical: str | None,
    mesh,
    rules: AxisRules,
    dim_size: int | None,
    taken: set[str],
) -> tuple[str, ...] | None:
    """Resolve one logical axis to mesh axes, dropping non-dividing/taken axes."""
    if logical is None:
        return None
    mapped = rules.get(logical)
    if mapped is None:
        return None
    if isinstance(mapped, str):
        mapped = (mapped,)
    shape = mesh_shape(mesh)
    out: list[str] = []
    shard = 1
    for ax in mapped:
        if ax not in shape or ax in taken:
            continue
        size = shape[ax]
        if dim_size is not None and (dim_size % (shard * size)) != 0:
            continue
        out.append(ax)
        shard *= size
    return tuple(out) or None


def logical_to_spec(
    logical_axes: Sequence[str | None],
    shape: Sequence[int] | None = None,
    mesh=None,
    rules: AxisRules | None = None,
) -> Spec:
    """Translate a tuple of logical axis names into a spec."""
    if mesh is None:
        mesh = _CTX.mesh
    if rules is None:
        rules = _CTX.rules or DEFAULT_RULES
    if mesh is None:
        return ()
    taken: set[str] = set()
    parts: list = []
    for i, name in enumerate(logical_axes):
        dim = None if shape is None else shape[i]
        axes = _resolve_axes(name, mesh, rules, dim, taken)
        if axes is not None:
            taken.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
        else:
            parts.append(None)
    # strip trailing Nones for a tidy spec
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def shard_act(x: torch.Tensor, logical_axes: Sequence[str | None]) -> torch.Tensor:
    """A logical sharding constraint on an activation: a no-op without a
    mesh, as in JAX.  With one it checks the annotation's rank and returns
    ``x``: each rank computes the part of the activation its own batch
    rows and weights give (``train.train_step``), so nothing moves here."""
    if _CTX.mesh is None:
        return x
    if len(logical_axes) != x.dim():
        raise ValueError(
            f"shard_act: {len(logical_axes)} logical axes for rank-{x.dim()} array"
        )
    return x


def _is_axes(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(a, (str, type(None))) for a in t)


def _tree_map(fn, tree, *rest):
    if _is_axes(tree):
        return fn(tree, *rest)
    return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}


def spec_placements(spec: Spec, mesh) -> list:
    """torch ``Shard(d)``/``Replicate()`` placements, one per mesh dimension,
    of ``spec`` on a named ``DeviceMesh`` (a dimension sharded over two
    mesh axes gives ``Shard(d)`` on each)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, part in enumerate(spec):
        for ax in (part,) if isinstance(part, str) else (part or ()):
            out[mesh.mesh_dim_names.index(ax)] = Shard(d)
    return out


def param_placements(
    logical_tree: Any,
    shape_tree: Any,
    mesh,
    rules: AxisRules | None = None,
) -> Any:
    """Each leaf's ``(spec, placements)`` on ``mesh``, JAX
    ``param_shardings``' counterpart: ``logical_tree`` mirrors the param
    tree with tuples of logical axis names as leaves (``lm.param_axes``),
    ``shape_tree`` holds each leaf's shape (a tensor or a tuple).  On a
    ``{axis: size}`` mapping the placements are ``None``."""
    def one(axes, s):
        shape = tuple(s.shape) if hasattr(s, "shape") else tuple(s)
        spec = logical_to_spec(axes, shape, mesh, rules)
        return spec, (None if isinstance(mesh, Mapping)
                      else spec_placements(spec, mesh))

    return _tree_map(one, logical_tree, shape_tree)
