"""Rank-side tasks of ``tests/test_torch_parallel.py``: each runs on every
rank of a :class:`Pool` world and imports only the port (the JAX
references run in the test process)."""

import shutil
import tempfile
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core.fbd.decouple import Residuals, make_decoupled_step
from repro_torch.launch.mesh import make_pipeline_mesh
from repro_torch.models import lm
from repro_torch.models.weights import from_jax_params, from_jax_train_state
from repro_torch.parallel.dist import exchange, join, leave
from repro_torch.parallel.plan import ParallelPlan, resolve_plan
from repro_torch.parallel.profiles import rules_for
from repro_torch.parallel.sharding import param_placements
from repro_torch.train import optim
from repro_torch.train.train_step import make_train_step


def _pool_worker(rank: int, size: int, device: str, workdir: str, tasks, results) -> None:
    torch.set_num_threads(1)
    join(rank, size, device=device, init_method=f"file://{workdir}/store")
    while True:
        task = tasks[rank].get()
        if task is None:
            break
        fn, args = task
        try:
            results.put((rank, "ok", fn(*args)))
        except Exception:  # noqa: BLE001 - handed to the caller
            results.put((rank, "error", traceback.format_exc()))
    leave()


class Pool:
    """A world of ``nprocs`` spawned ranks kept alive across calls:
    ``pool.run(fn, *args)`` runs ``fn(*args)`` on every rank (a function
    importable by name) and returns their results in rank order.  A call
    that does not finish within ``timeout`` seconds, or whose rank raises,
    raises here; the pool is closed then."""

    def __init__(self, nprocs: int, device: str = "cpu", timeout: float = 600.0):
        import torch.multiprocessing as mp

        self.nprocs, self.timeout = nprocs, timeout
        self._workdir = tempfile.mkdtemp(prefix="repro_torch_pool_")
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(nprocs)]
        self._results = ctx.Queue()
        self._ctx = mp.start_processes(
            _pool_worker, args=(nprocs, str(device), self._workdir, self._tasks,
                                self._results),
            nprocs=nprocs, join=False, start_method="spawn")

    def run(self, fn: Callable, *args) -> list:
        import queue

        for q in self._tasks:
            q.put((fn, args))
        out: dict[int, Any] = {}
        while len(out) < self.nprocs:
            try:
                rank, status, value = self._results.get(timeout=self.timeout)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"{fn.__name__} did not finish on every rank "
                                   f"within {self.timeout} s") from None
            if status == "error":
                self.close()
                raise RuntimeError(f"{fn.__name__} failed on rank {rank}:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.nprocs)]

    def close(self) -> None:
        if self._ctx is None:
            return
        for q in self._tasks:
            q.put(None)
        for p in self._ctx.processes:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        self._ctx = None
        shutil.rmtree(self._workdir, ignore_errors=True)


def send_tensors(tensors: list[torch.Tensor], dst: int) -> None:
    """Send a list of tensors to rank ``dst``: their shapes and dtypes
    first, then the tensors (:func:`recv_tensors` on the other side)."""
    dist.send_object_list([[(tuple(t.shape), str(t.dtype).removeprefix("torch."))
                            for t in tensors]], dst=dst)
    exchange([(t, dst) for t in tensors], [])


def recv_tensors(src: int, device: str | torch.device = "cpu") -> list[torch.Tensor]:
    """The tensors :func:`send_tensors` sent from rank ``src``, on ``device``."""
    meta = [None]
    dist.recv_object_list(meta, src=src)
    bufs = [torch.empty(shape, dtype=getattr(torch, dt), device=device)
            for shape, dt in meta[0]]
    exchange([], [(b, src) for b in bufs])
    return bufs


def _np_tree(tree: dict) -> dict:
    return {k: _np_tree(v) if isinstance(v, dict) else v.detach().cpu().numpy()
            for k, v in tree.items()}


def train_cell(cfg, plan_kw: dict, state_np: dict, batches: list, ocfg_kw: dict,
               grad_accum: int = 1, ckpt: tuple[str, int] | None = None) -> dict:
    """Steps of ``make_train_step`` on this rank of a (stage, data, model)
    mesh from the whole ``state_np`` over ``batches`` (numpy: token
    batches, or ``make_batch``'s for an embeds arch, the encoder-decoder's
    frames and target tokens among them): the losses, the first step's
    synced gradients and the final master of this rank's part, and on rank
    0 the whole final master gathered from the parts (``gather_state``).
    ``ckpt = (directory, step)``: after that step the whole state gathered
    from the parts is saved there on rank 0, as the train loop saves it,
    and this rank's part of it is returned as ``saved``."""
    from repro_torch.checkpoint.checkpointer import save

    plan = resolve_plan(ParallelPlan(**plan_kw))
    mesh = make_pipeline_mesh(plan.pp, plan.dp, plan.tp)
    grads = []

    def capture(g):
        if not grads:
            grads.append(_np_tree(g))
        return g

    step = make_train_step(cfg, optim.OptimizerConfig(**ocfg_kw), grad_accum=grad_accum,
                           plan=plan, mesh=mesh, grad_transform=capture)
    state = step.parallel.shard_state(from_jax_train_state(state_np, device="cpu"))
    losses, metrics, saved = [], [], None
    for i, b in enumerate(batches, 1):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        metrics.append({k: float(v) for k, v in m.items()
                        if isinstance(v, torch.Tensor) and v.dim() == 0})
        if ckpt is not None and i == ckpt[1]:
            # copies: the next step updates the state in place
            saved = {k: _np_tree(optim.tree_map(torch.clone, t)) for k, t in (
                ("master", state.master), ("m", state.opt["m"]), ("v", state.opt["v"]))}
            whole_state = step.parallel.gather_state(state)
            if whole_state is not None:
                save(whole_state, i, ckpt[0])
    whole = step.parallel.gather_state(state)
    return {"losses": losses, "metrics": metrics, "grads": grads[0],
            "master": _np_tree(state.master),
            "whole": None if whole is None else _np_tree(whole.master),
            "coords": step.parallel.coords, "saved": saved}


def refusal(cfg, plan_kw: dict, compress: bool = False) -> str:
    """The message of the ``NotImplementedError`` or ``ValueError``
    ``make_train_step`` raises for ``cfg`` under ``plan_kw`` on this rank's
    mesh (with int8 compression if ``compress``), or ``""``."""
    from repro_torch.ft import GradCompressor

    plan = resolve_plan(ParallelPlan(**plan_kw))
    mesh = make_pipeline_mesh(plan.pp, plan.dp, plan.tp)
    try:
        make_train_step(cfg, optim.OptimizerConfig(), plan=plan, mesh=mesh,
                        compressor=GradCompressor() if compress else None)
    except (NotImplementedError, ValueError) as e:
        return str(e)
    return ""


def placements(cfg, shape: tuple, axes: tuple) -> dict:
    """``param_placements`` of every leaf on a mesh of the world's ranks:
    ``{path: (spec, [placement names])}``."""
    from repro_torch.launch.mesh import _mesh

    mesh = _mesh(shape, axes, "test")
    out = param_placements(lm.param_axes(cfg), _shapes(cfg), mesh, rules_for(cfg, "train"))
    flat = {}

    def walk(tree, path):
        if isinstance(tree, tuple) and len(tree) == 2 and isinstance(tree[1], list):
            flat[path] = (tree[0], [repr(p) for p in tree[1]])
            return
        for k, v in tree.items():
            walk(v, (*path, k))

    walk(out, ())
    return flat


def _shapes(cfg) -> dict:
    return optim.tree_map(lambda t: tuple(t.shape),
                          lm.init(cfg, seed=0, device="cpu"))


def bwd_elsewhere(cfg, params_np: dict, batch_np: dict) -> dict:
    """MegaFBD's ``bwd`` on rank 1 from what rank 0's ``fwd`` sends it
    (parameters, batch, residual tensors, cotangent), and rank 0's own
    in-process ``bwd``: each rank's gradients."""
    step = make_decoupled_step(lambda p, b: lm.loss_fn(cfg, p, b)[0])
    paths = [path for path, _ in optim.leaves(params_np)]
    keys = sorted(batch_np)
    if dist.get_rank() == 0:
        params = from_jax_params(params_np, device="cpu")
        for _, leaf in optim.leaves(params):
            leaf.requires_grad_(True)
        batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        loss, res = step.fwd(params, batch)
        ct = torch.ones_like(loss)
        send_tensors([leaf.detach() for _, leaf in optim.leaves(params)]
                     + [batch[k] for k in keys] + res.tensors + [ct], dst=1)
        grads = step.bwd(params, batch, res, ct)
        return {"grads": _np_tree(grads), "residuals": len(res.tensors)}
    got = recv_tensors(src=0)
    params: dict = {}
    for path, t in zip(paths, got):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.requires_grad_(True)
    batch = dict(zip(keys, got[len(paths):len(paths) + len(keys)]))
    res = Residuals(tensors=got[len(paths) + len(keys):-1])
    grads = step.bwd(params, batch, res, got[-1])
    return {"grads": _np_tree(grads), "residuals": len(res.tensors)}


def run_cli(argv: list[str]) -> dict:
    """``python -m repro_torch train`` with ``argv`` on this rank, in the
    world the pool joined (its ``Session`` runs in place, as ``cli.run``
    runs it): its history, the size of its world and the final train state
    of this rank's part."""
    from repro_torch.app.cli import parse
    from repro_torch.app.session import Session

    session = Session(parse(argv)[1])
    state, history = session.run()
    return {"history": history, "world": session.results["parallel"]["world"],
            "state": {"master": _np_tree(state.master), "m": _np_tree(state.opt["m"]),
                      "v": _np_tree(state.opt["v"])}}
