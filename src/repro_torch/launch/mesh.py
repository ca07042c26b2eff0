"""Device meshes over the ranks of a world, counterpart of
``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions over the ranks of the world this process joined
(``parallel.dist``); rank order is JAX's ``np.asarray(devs).reshape(...)``.
A mesh that needs more ranks than the world holds raises a ``ValueError``
naming both counts.  These are functions, not module constants, so
importing this module touches no process group.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel import dist as pdist


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], what: str):
    need = int(np.prod(shape))
    have = pdist.world_size()
    if have < need:
        raise ValueError(
            f"{what} mesh {' x '.join(f'{a}={n}' for a, n in zip(axes, shape))} "
            f"needs {need} ranks, the world has {have} (spawn them with "
            f"parallel.pp/dp/tp or start them with torchrun)")
    from torch.distributed.device_mesh import DeviceMesh

    w = pdist.world()
    ranks = torch.arange(need, dtype=torch.int).reshape(shape)
    return DeviceMesh(w.device.type, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, "production")


def make_host_mesh(data: int = 4, model: int = 2):
    """A small (data, model) mesh over the world's ranks, JAX's
    ``make_host_mesh``: ``data`` and ``model`` are cut to what the world
    holds.  A world of one rank with no process group has no mesh: None,
    where every sharding annotation is a no-op."""
    n = pdist.world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    if (data, model) == (2, 4):
        # fail as the JAX function fails, so the two agree on every shape
        raise ValueError(
            "host mesh shape data=2 x model=4 is known to segfault this "
            "jaxlib's CPU backend while compiling SPMD programs; use the "
            "transposed make_host_mesh(data=4, model=2) (the default) instead"
        )
    if pdist.world() is None:
        return None
    return _mesh((data, model), ("data", "model"), "host")


def make_pipeline_mesh(pp: int, dp: int = 1, tp: int = 1):
    """(stage, data, model) mesh for composed training over the world's
    first ``pp*dp*tp`` ranks: ``stage`` carries the pipeline's hand-offs,
    ``data`` shards the batch (one pipeline per dp group; gradients
    all-reduce over it) and ``model`` slices heads and ffn inside each
    block (``models.pipeline``)."""
    return _mesh((pp, dp, tp), ("stage", "data", "model"), "pipeline")


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a mesh (``{}`` for None)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
