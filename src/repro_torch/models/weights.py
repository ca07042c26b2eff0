"""Parameter conversion between the JAX package's tree and the port's.

Both sides keep the same nested-dict tree with the same leaf names, shapes
and layouts (``lm.init`` in either package), so conversion is a copy of each
leaf.  The JAX side's leaves cross as numpy arrays: this module imports
neither JAX nor anything of ``repro``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def from_jax_params(tree: dict, device: str = "cuda") -> dict:
    """Port parameters from a tree of arrays (numpy, or anything
    ``np.asarray`` takes) shaped like ``repro.models.lm.init``'s output."""
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
