"""Decoupled forward/backward execution (MegaFBD §4.1-4.2), counterpart of
``repro.core.fbd.decouple``.

PyTorch binds F and B to one autograd graph; MegaFBD splits them into
separate instances.  Here one loss splits into two calls:

    fwd(params, batch)                  -> (loss, residuals)   [forward instance]
    bwd(params, batch, residuals, ct)   -> grads               [backward instance]

``fwd`` runs the loss under ``torch.autograd.graph.saved_tensors_hooks``:
every tensor autograd saves for the backward goes through the pack hook.
A parameter or batch tensor (a view of one included), which both instances
hold, stays a reference; every other one lands in ``residuals.tensors``,
the F→B transfer MegaFBD's coordinator manages, and the graph keeps only
its index.  ``bwd`` runs ``torch.autograd.grad`` through unpack hooks that
read ``residuals.tensors`` as they are then: moved to the host and back,
or to another device, the backward reads the moved copies.

A backward instance in another process gets ``(params, batch, residuals,
ct)`` over the group, ``residuals`` holding only the tensors: its ``bwd``
rebuilds the graph, as JAX's ``bwd`` re-derives the vjp and applies the
residuals.  It reruns the forward under the same hooks (the saves come in
the same order, each once) and the unpack hooks read the received
tensors in place of the recomputed ones, so the gradients are the
in-process ``bwd``'s, bit for bit, also where the forward is not
deterministic.  Where it is, the rerun's own residuals already equal the
forward instance's: the pipeline executor (``core.dpp.executor``) sends
the backward instance only a cell's input and calls ``fwd`` then ``bwd``
there, with no residual transfer.

Under remat (``torch.utils.checkpoint``) a checkpointed layer's own saves
go to checkpoint's inner hooks and are recomputed in the backward; what
the layer keeps for that recompute, its inputs, checkpoint saves through
the ambient hooks, so they are residuals too.  ``residuals.nbytes`` is the
transfer volume.  The mesh and sharding-rule arguments are the JAX
signature's; on one device they change nothing, as in JAX without a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.train.optim import leaves, tree_map


@dataclass
class Residuals:
    """What ``fwd`` hands ``bwd``: ``tensors``, the saved activations in the
    order first saved (each once), replaceable by copies of the same
    values; the graph that reads them rides along."""

    tensors: list[torch.Tensor] = field(default_factory=list)
    _loss: torch.Tensor | None = None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors)

    def to(self, device) -> "Residuals":
        """Move every tensor to ``device`` in place (a synchronous copy);
        returns ``self``."""
        self.tensors = [t.to(device) for t in self.tensors]
        return self


@dataclass
class DecoupledStep:
    fwd: Callable             # (params, batch) -> (loss, residuals)
    bwd: Callable             # (params, batch, residuals, cotangent) -> grads
    residual_bytes: Callable  # (params, batch) -> int  (transfer volume)


def _storages(tree: dict) -> set[int]:
    return {t.untyped_storage().data_ptr()
            for _, t in leaves(tree) if isinstance(t, torch.Tensor)}


def make_decoupled_step(
    loss_fn: Callable,                 # (params, batch) -> scalar loss
    *,
    fwd_mesh=None,
    fwd_rules=None,
    bwd_mesh=None,
    bwd_rules=None,
) -> DecoupledStep:
    def fwd(params, batch):
        res = Residuals()
        held = _storages(params) | _storages(batch)
        kept: list[torch.Tensor] = []    # parameter and batch tensors
        index: dict[tuple, int] = {}

        def pack(t: torch.Tensor):
            if t.untyped_storage().data_ptr() in held:
                kept.append(t)
                return False, len(kept) - 1
            key = (t.data_ptr(), t.dtype, tuple(t.shape), t.stride(), t.device)
            if key not in index:
                index[key] = len(res.tensors)
                res.tensors.append(t.detach())
            return True, index[key]

        def unpack(ref) -> torch.Tensor:
            moved, i = ref
            return res.tensors[i] if moved else kept[i]

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            res._loss = loss_fn(params, batch)
        return res._loss.detach(), res

    def bwd(params, batch, residuals: Residuals, ct):
        """The gradients of ``params``.  ``residuals`` from this process's
        ``fwd`` carry its graph: ``batch`` is not read and ``params`` only
        orders the leaves (the weights ``fwd`` ran on).  ``residuals``
        received from another process carry only their tensors: the graph
        is rebuilt here from this process's ``params`` and ``batch`` (the
        forward instance's values), reading those tensors."""
        if residuals._loss is None:
            received = residuals.tensors
            residuals = fwd(params, batch)[1]
            mine = residuals.tensors
            if [(t.shape, t.dtype) for t in mine] != [(t.shape, t.dtype) for t in received]:
                raise ValueError(
                    f"{len(received)} residuals received do not match the "
                    f"{len(mine)} this forward saves")
            with torch.no_grad():
                for t, r in zip(mine, received):  # in place: the saves' strides
                    t.copy_(r)
        flat = [p for _, p in leaves(params)]
        loss, residuals._loss = residuals._loss, None
        grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat, ct)))
        return tree_map(lambda p: grads[id(p)], params)

    def residual_bytes(params, batch) -> int:
        return fwd(params, batch)[1].nbytes

    return DecoupledStep(fwd=fwd, bwd=bwd, residual_bytes=residual_bytes)


def decoupled_grad(step: DecoupledStep, params: Any, batch: Any):
    """Convenience: run fwd then bwd and return (loss, grads).  Matches
    ``torch.autograd.grad`` bit for bit: the same graph, the same kernels."""
    loss, residuals = step.fwd(params, batch)
    grads = step.bwd(params, batch, residuals, torch.ones_like(loss))
    return loss, grads
