"""Parameter and train-state conversion between the JAX package's trees and
the port's.

Both sides keep the same nested-dict tree with the same leaf names, shapes
and layouts (``lm.init`` or ``encdec.init`` in either package), so
conversion is a copy of each leaf.  The JAX side's leaves cross as numpy
arrays: this module imports neither JAX nor anything of ``repro``.  Under
tensor parallelism each rank holds its slice of that tree
(:func:`shard_params`), and :func:`unshard_params` puts the whole tree back
together.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def from_jax_params(tree: dict, device: str = "cuda") -> dict:
    """Port parameters from a tree of arrays (numpy, or anything
    ``np.asarray`` takes) shaped like the JAX package's ``init`` output."""
    dev = resolve_device(device)
    return {
        k: from_jax_params(v, dev) if isinstance(v, dict)
        else torch.from_numpy(np.array(v, copy=True)).to(dev)
        for k, v in tree.items()
    }


def to_jax_params(params: dict) -> dict:
    """The inverse: a tree of numpy arrays ``jax.tree.map(jnp.asarray, ...)``
    turns back into JAX parameters."""
    return {
        k: to_jax_params(v) if isinstance(v, dict) else v.detach().cpu().numpy()
        for k, v in params.items()
    }


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int32": torch.int32}


def _tensor(a, dev: torch.device) -> torch.Tensor:
    """A numpy-like array as a tensor of the same dtype; bfloat16 arrays
    (numpy's ``ml_dtypes`` extension type) cross exactly through float32."""
    arr = np.asarray(a)
    dtype = _DTYPES.get(arr.dtype.name)
    if dtype is None:
        raise TypeError(f"cannot convert a {arr.dtype} leaf")
    return torch.from_numpy(arr.astype(np.float32 if dtype == torch.bfloat16
                                       else arr.dtype, copy=True)).to(dev, dtype)


def _tree(tree: dict, dev: torch.device) -> dict:
    return {k: _tree(v, dev) if isinstance(v, dict) else _tensor(v, dev)
            for k, v in tree.items()}


def _get(obj, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def from_jax_train_state(state, device: str = "cuda"):
    """A port ``TrainState`` from the JAX package's ``TrainState`` with numpy
    leaves (``jax.tree.map(np.asarray, state)``), or a dict of the same
    shape: ``params`` in the compute dtype, float32 ``master``, ``opt`` with
    ``m``, ``v`` and ``step``."""
    from repro_torch.train.train_step import TrainState

    dev = resolve_device(device)
    opt = _get(state, "opt")
    params = _tree(_get(state, "params"), dev)
    _requires_grad(params)
    return TrainState(
        params=params, master=_tree(_get(state, "master"), dev),
        opt={"m": _tree(opt["m"], dev), "v": _tree(opt["v"], dev),
             "step": int(np.asarray(opt["step"]))})


def _requires_grad(tree: dict) -> None:
    for v in tree.values():
        if isinstance(v, dict):
            _requires_grad(v)
        else:
            v.requires_grad_(True)


def to_jax_train_state(state) -> dict:
    """The inverse, as a dict of numpy trees ``{"params", "master", "opt":
    {"m", "v", "step"}}``.  bfloat16 leaves come back as float32 arrays
    holding the same values (numpy has no bfloat16 of its own): cast them
    back with ``.astype(jnp.bfloat16)``, which is exact."""
    def np_tree(tree):
        return {k: np_tree(v) if isinstance(v, dict)
                else v.detach().float().cpu().numpy() if v.dtype == torch.bfloat16
                else v.detach().cpu().numpy() for k, v in tree.items()}

    return {"params": np_tree(state.params), "master": np_tree(state.master),
            "opt": {"m": np_tree(state.opt["m"]), "v": np_tree(state.opt["v"]),
                    "step": np.int32(state.opt["step"])}}


def shard_params(params: dict, layout, tp_rank: int, *, axes: dict) -> dict:
    """Tensor rank ``tp_rank``'s part of the whole tree ``params`` under
    ``layout.tp``: each leaf the Megatron split slices (``axes``:
    ``lm.param_axes``; ``models.pipeline.tp_slices``) cut to its ``tp_rank``-th
    of ``tp`` equal pieces along that dim, as a contiguous copy; every other
    leaf shared as it is.  Each rank cuts the same ``from_jax_params`` (or
    seeded) tree."""
    from repro_torch.models.pipeline import tp_slices

    dims = tp_slices(axes, layout)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = (*path, k)
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif p in dims:
                out[k] = v.detach().chunk(layout.tp, dim=dims[p])[tp_rank].contiguous()
            else:
                out[k] = v
        return out

    return walk(params, ())


def unshard_params(shards: list[dict], layout, *, axes: dict) -> dict:
    """The inverse of :func:`shard_params`: the whole tree from every tensor
    rank's part (rank order); the leaves that are not sliced come from
    rank 0's."""
    from repro_torch.models.pipeline import tp_slices

    dims = tp_slices(axes, layout)

    def walk(trees, path):
        out = {}
        for k, v in trees[0].items():
            p = (*path, k)
            if isinstance(v, dict):
                out[k] = walk([t[k] for t in trees], p)
            elif p in dims:
                out[k] = torch.cat([t[k] for t in trees], dim=dims[p])
            else:
                out[k] = v
        return out

    return walk(shards, ())
