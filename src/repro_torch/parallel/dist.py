"""Process worlds for data, tensor and pipeline parallelism: the port's own
module, with no JAX counterpart (GSPMD does this for the JAX package).

* **Joining.**  Under ``torchrun`` (``RANK``/``WORLD_SIZE`` set) a rank
  joins in place (:func:`join_from_env`); otherwise :func:`spawn` starts
  ``n`` ranks with ``torch.multiprocessing`` (start method ``spawn``), each
  joining through a file store in a fresh temporary directory, and returns
  every rank's result, rank 0's first.
* **Devices.**  A rank's device is ``cuda:{local_rank % device_count()}``,
  or the CPU when ``cpu`` is asked (:func:`rank_device`).
* **Backend, by a stated rule** (:func:`pick_backend`): ``nccl`` when the
  ranks of a host hold distinct cards, ``gloo`` when ranks share a card or
  run on the CPU.  The choice is logged and kept in :attr:`World.backend`.
* **Megatron's conjugate pair**: :func:`copy_to_tp` (identity forward,
  all-reduce backward) at a tensor-parallel block's input and
  :func:`reduce_from_tp` (all-reduce forward, identity backward) after the
  attention-out and MLP-down products.  Both sum in float32.
* **Gradient sums** (:func:`all_reduce_tree`): one flat float32 buffer a
  gradient dtype, all-reduced over a group.
* **Pipeline hand-offs** (:func:`exchange`): posted sends and receives,
  waited together; gloo has no send/recv for CUDA tensors, so under gloo
  they go through host buffers.
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
import tempfile
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

log = logging.getLogger("repro_torch.parallel")


@dataclass(frozen=True)
class World:
    """This process's place in the world it joined."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str


_WORLD: World | None = None


def world() -> World | None:
    """The world this process joined, or None (one process, no group)."""
    return _WORLD


def world_size() -> int:
    return 1 if _WORLD is None else _WORLD.size


def rank_device(local_rank: int, device: str | torch.device = "cuda") -> torch.device:
    """``cuda:{local_rank % device_count()}``, or the CPU when asked; a CUDA
    request where there is no card raises (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def pick_backend(device: torch.device, local_size: int) -> str:
    """``nccl`` when the ``local_size`` ranks of a host each hold a card of
    their own; ``gloo`` when they share cards or run on the CPU."""
    if device.type == "cuda" and local_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def join(rank: int, size: int, *, device: str | torch.device, init_method: str,
         local_rank: int | None = None, local_size: int | None = None) -> World:
    """Join a world of ``size`` ranks as ``rank`` (``torch.distributed``'s
    default group) and set this process's card."""
    global _WORLD
    if _WORLD is not None:
        raise RuntimeError(f"this process already joined a world ({_WORLD})")
    local_rank = rank if local_rank is None else local_rank
    dev = rank_device(local_rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = pick_backend(dev, size if local_size is None else local_size)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size)
    _WORLD = World(rank=rank, size=size, local_rank=local_rank, device=dev,
                   backend=backend)
    log.info("rank %d of %d on %s, backend %s (%s)", rank, size, dev, backend,
             "a card each" if backend == "nccl" else
             "ranks share a card" if dev.type == "cuda" else "the CPU")
    return _WORLD


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def join_from_env(device: str | torch.device) -> World:
    """Join the world ``torchrun`` describes in the environment."""
    env = os.environ
    return join(int(env["RANK"]), int(env["WORLD_SIZE"]), device=device,
                init_method="env://", local_rank=int(env.get("LOCAL_RANK", 0)),
                local_size=int(env.get("LOCAL_WORLD_SIZE", env["WORLD_SIZE"])))


def leave() -> None:
    """Leave the world (destroy the default group)."""
    global _WORLD
    if _WORLD is not None:
        dist.destroy_process_group()
        _WORLD = None


# ---------------------------------------------------------------- spawning


def _spawned(rank: int, fn: Callable, args: tuple, size: int, device: str,
             workdir: str) -> None:
    torch.set_num_threads(1)
    out = Path(workdir) / f"rank{rank}.pkl"
    try:
        join(rank, size, device=device, init_method=f"file://{workdir}/store")
        result = ("ok", fn(*args))
    except Exception as e:  # handed to the parent, which raises it
        result = ("error", (e, traceback.format_exc()))
    try:
        payload = pickle.dumps(result)
    except Exception as e:  # noqa: BLE001 - an unpicklable error or result
        payload = pickle.dumps(("error", (RuntimeError(repr(e)), traceback.format_exc())))
    out.write_bytes(payload)
    if result[0] == "error":
        # a non-zero exit makes the parent end the other ranks, which may
        # wait in a collective for this one
        os._exit(1)
    leave()


def spawn(fn: Callable, args: tuple, nprocs: int, device: str = "cuda") -> list:
    """Run ``fn(*args)`` on ``nprocs`` new ranks that join one world; the
    list of their results in rank order.  A rank's exception is raised here
    (the lowest rank's first), with its traceback logged."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    if nprocs > 1 and torch.device(device).type == "cuda":
        resolve_device(device)  # no card: raise here, before any rank starts
    workdir = tempfile.mkdtemp(prefix="repro_torch_world_")
    try:
        try:
            mp.start_processes(_spawned, args=(fn, args, nprocs, str(device), workdir),
                               nprocs=nprocs, join=True, start_method="spawn")
        except ProcessException as e:
            failed = e
        else:
            failed = None
        results = []
        for r in range(nprocs):
            path = Path(workdir) / f"rank{r}.pkl"
            if not path.exists():
                results.append(("error", (RuntimeError(
                    f"rank {r} ended without a result: {failed}"), "")))
                continue
            results.append(pickle.loads(path.read_bytes()))
        # a rank's own exception before the "ended without a result" of a
        # rank ended because of it
        errors = sorted(((not value[1], r, value) for r, (status, value)
                         in enumerate(results) if status == "error"),
                        key=lambda e: e[:2])
        if errors:
            _, r, (exc, tb) = errors[0]
            log.error("rank %d failed:\n%s", r, tb)
            raise exc
        return [value for _, value in results]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ------------------------------------------------------- collectives


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The float32 sum of ``x`` over ``group``, in ``x``'s dtype."""
    buf = x.to(torch.float32, copy=True)
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``: identity forward, all-reduce of the gradient over
    the tensor ranks backward (a replicated input of sliced products)."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g``: all-reduce of the partial products forward,
    identity backward (the gradient of a replicated output is whole)."""
    return _ReduceFromTP.apply(x, group)


def all_reduce_tree(tree: dict, group) -> dict:
    """Every leaf summed over ``group``: the leaves of each dtype packed
    into one flat float32 buffer, all-reduced once, unpacked as float32
    leaves (the optimizer takes float32 gradients)."""
    from repro_torch.train.optim import leaves, parent, tree_map

    flat = list(leaves(tree))
    out = tree_map(lambda g: g, tree)
    for dtype in sorted({g.dtype for _, g in flat}, key=str):
        part = [(p, g) for p, g in flat if g.dtype == dtype]
        buf = torch.cat([g.reshape(-1).to(torch.float32) for _, g in part])
        dist.all_reduce(buf, group=group)
        at = 0
        for path, g in part:
            parent(out, path)[path[-1]] = buf[at:at + g.numel()].view(g.shape)
            at += g.numel()
    return out


def all_reduce_scalar(x: torch.Tensor, group) -> torch.Tensor:
    """A 0-dim float32 tensor summed over ``group``."""
    buf = x.detach().to(torch.float32).reshape(1).clone()
    dist.all_reduce(buf, group=group)
    return buf[0]


def exchange(sends: list[tuple[torch.Tensor, int]],
             recvs: list[tuple[torch.Tensor, int]]) -> None:
    """Post every send ``(tensor, dst rank)`` and receive ``(buffer, src
    rank)`` at once, then wait for all: the receive buffers are filled in
    place (a buffer that is not contiguous through a contiguous copy).
    Under gloo a CUDA tensor crosses through a host copy."""
    host = _WORLD is not None and _WORLD.backend == "gloo"
    staged = []
    ops = []
    for t, dst in sends:
        t = t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if host and t.is_cuda else t, dst))
    for buf, src in recvs:
        tmp = buf
        if (host and buf.is_cuda) or not buf.is_contiguous():
            tmp = torch.empty(buf.shape, dtype=buf.dtype,
                              device="cpu" if host else buf.device)
        staged.append((buf, tmp))
        ops.append(dist.P2POp(dist.irecv, tmp, src))
    if not ops:
        return
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    for buf, tmp in staged:
        if tmp is not buf:
            buf.copy_(tmp)

