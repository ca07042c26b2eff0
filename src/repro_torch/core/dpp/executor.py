"""Pipeline executor driven by MegaDPP schedule tables, counterpart of
``repro.core.dpp.executor``.

The planner picks the traversal order ahead of time; :func:`build_time_table`
places it greedily into static ``[T, S]`` tables (the same tables, entry for
entry, as the JAX package's), and :func:`pipeline_apply` walks them tick by
tick: every stage that the table marks active runs its (microbatch, chunk)
cell and hands the result to the next stage.

Interleaving layout: global block (c, s) = chunk c on stage s; value flow
(c, s) -> (c, s+1), wrapping (c, S-1) -> (c+1, 0), so every transfer goes to
stage (s + 1) mod S.

JAX runs the table as one SPMD program (``shard_map`` over a ``stage`` mesh
axis, a ring ``ppermute`` a tick), which has to compute every (tick, stage)
slot and mask the idle ones.  Here only the active slots run, in one of two
ways (:func:`make_pipeline_stages`):

* one process drives every stage (:func:`pipeline_apply`): a stage is a
  ``torch.device``, a hand-off is ``.to(stages[dst])`` and the backward is
  autograd through the forward's graph, the mirror of the table, as the
  transpose of JAX's scan replays its ticks in reverse;
* each stage is a process of a (stage, data, model) mesh
  (:func:`pipeline_ranks_apply`): a rank runs only its own stage's cells,
  a hand-off is a send to stage ``(s + 1) mod S``'s rank, and the
  backward walks the mirrored table cell by cell, each cell's backward
  taking the gradient of its output from the rank it sent the output to
  and sending its input's gradient back.  With MegaFBD
  (``core.fbd.decouple``) a stage's backward runs on the next stage's
  process, which rebuilds the cell's graph from the input the forward's
  process sends it (the forward there keeps no graph).

``params`` may be any tree (nested dicts) whose leaves are stage-major
stacked ``[S, C, ...]`` tensors, or one such tensor; activations may have any
trailing shape.  ``repro_torch.models.pipeline`` builds the stacked block
trees and the per-cell ``block_fn`` of the real model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.dpp.schedule import Step
from repro_torch.core.tracing.events import TraceEvent
from repro_torch.device import resolve_device
from repro_torch.train.optim import tree_map


@dataclass
class TimeTable:
    """Static dispatch tables [T, S]: what each stage runs/receives per step."""
    run_m: np.ndarray
    run_c: np.ndarray
    run_act: np.ndarray
    recv_m: np.ndarray
    recv_c: np.ndarray      # destination chunk slot at the receiver
    recv_act: np.ndarray
    recv_fin: np.ndarray    # receipt is a final output (write to out buffer)
    steps: int


def build_time_table(
    order: list[Step], n_stages: int, n_chunks: int, n_micro: int
) -> TimeTable:
    """Greedy legal placement of the desired visit order: at each step every
    stage runs its highest-priority *ready* pending (m, c) — the static
    analogue of "always pick the highest-priority ready input"."""
    fwd = [(m, c) for kind, m, c in order if kind == "F"]
    pending = {s: list(fwd) for s in range(n_stages)}
    ready: dict[tuple[int, int, int], int] = {
        (m, 0, 0): 0 for m in range(n_micro)
    }
    placed: list[list[tuple[int, int] | None]] = []
    done = 0
    total = n_stages * len(fwd)
    t = 0
    max_steps = total + n_stages * n_chunks * n_micro + 16
    while done < total and t < max_steps:
        row: list[tuple[int, int] | None] = []
        for s in range(n_stages):
            pick = None
            for i, (m, c) in enumerate(pending[s]):
                r = ready.get((m, c, s))
                if r is not None and r <= t:
                    pick = (i, m, c)
                    break
            if pick is None:
                row.append(None)
                continue
            i, m, c = pick
            pending[s].pop(i)
            done += 1
            row.append((m, c))
            # successor becomes ready next step
            if s < n_stages - 1:
                ready[(m, c, s + 1)] = t + 1
            elif c < n_chunks - 1:
                ready[(m, c + 1, 0)] = t + 1
        placed.append(row)
        t += 1
    if done < total:
        raise RuntimeError("schedule could not be legalized (cyclic order)")

    T = len(placed) + 1  # one extra step to flush the last hand-off
    S = n_stages
    run_m = np.zeros((T, S), np.int32)
    run_c = np.zeros((T, S), np.int32)
    run_act = np.zeros((T, S), bool)
    recv_m = np.zeros((T, S), np.int32)
    recv_c = np.zeros((T, S), np.int32)
    recv_act = np.zeros((T, S), bool)
    recv_fin = np.zeros((T, S), bool)
    for t, row in enumerate(placed):
        for s, entry in enumerate(row):
            if entry is None:
                continue
            m, c = entry
            run_m[t, s], run_c[t, s], run_act[t, s] = m, c, True
            # the receiver sees this value at step t+1
            dst = (s + 1) % S
            if s < S - 1:
                dc, fin = c, False
            elif c < n_chunks - 1:
                dc, fin = c + 1, False
            else:
                dc, fin = 0, True
            recv_m[t + 1, dst], recv_c[t + 1, dst] = m, dc
            recv_act[t + 1, dst], recv_fin[t + 1, dst] = True, fin
    return TimeTable(run_m, run_c, run_act, recv_m, recv_c, recv_act, recv_fin, T)


def bubble_fraction(table: TimeTable) -> float:
    """Fraction of (step, stage) slots in the forward table that are idle.

    The denominator includes the final flush step, so the number is directly
    comparable across schedules for the same (S, C, n_micro) problem.
    """
    run_act = np.asarray(table.run_act)
    T, S = run_act.shape
    busy = int(run_act.sum())
    return 1.0 - busy / float(T * S)


def make_pipeline_stages(pp: int, device: str | torch.device = "cuda", mesh=None
                         ) -> list:
    """The stage map of a ``pp``-stage pipeline, counterpart of
    ``repro.launch.mesh.make_pipeline_mesh``'s ``stage`` axis.  Without a
    mesh one process drives every stage: all ``pp`` stages are its device
    (the card, or the CPU), and a stage's hand-off is a no-op ``.to``.
    With a (stage, data, model) mesh each stage is a process: the global
    rank of each stage in this process's (data, model) line, the ranks
    :func:`pipeline_ranks_apply` hands activations between."""
    if pp < 1:
        raise ValueError(f"pipeline stages must be >= 1, got {pp}")
    if mesh is None:
        return [resolve_device(device)] * pp
    names = list(mesh.mesh_dim_names)
    coord = dict(zip(names, mesh.get_coordinate()))
    grid = mesh.mesh
    if grid.shape[names.index("stage")] != pp:
        raise ValueError(f"mesh stage axis {grid.shape[names.index('stage')]} != pp={pp}")
    index = tuple(slice(None) if n == "stage" else coord[n] for n in names)
    return [int(r) for r in grid[index].tolist()]


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree: Any) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def pipeline_apply(
    params: Any,                       # tree of [S, C, ...] stacked blocks
    x_micro: torch.Tensor,             # [n_micro, ...] microbatch inputs
    table: TimeTable,
    *,
    stages: list[torch.device],
    block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """Runs the pipelined forward; returns [n_micro, ...] final activations
    on ``stages[0]`` (where the last chunk's outputs land).  Differentiable:
    the backward pipelines through autograd.

    ``block_fn`` receives one cell's params (leaves indexed down to
    ``[...]``, the stage and chunk axes consumed) and one microbatch
    activation of shape ``x_micro.shape[1:]``; it is called only where
    ``table.run_act`` is set, n_micro * S * C times in all.  The cells'
    parameter views are taken once a call, under the caller's grad mode,
    so autograd sums every cell's gradient into the stacked leaves.
    """
    S = len(stages)
    C = _first_leaf(params).shape[1]
    if _first_leaf(params).shape[0] != S:
        raise ValueError(f"params stacked for {_first_leaf(params).shape[0]} "
                         f"stages, {S} given")
    cells = {(s, c): _tree_map(lambda a, s=s, c=c: a[s, c].to(stages[s]), params)
             for s in range(S) for c in range(C)}
    n_micro = x_micro.shape[0]
    inbox: list[dict[tuple[int, int], torch.Tensor]] = [{} for _ in range(S)]
    out: list[torch.Tensor | None] = [None] * n_micro
    wire: list[torch.Tensor | None] = [None] * S
    for t in range(table.steps):
        # 1. deposit what arrived on the wire last step
        for s in range(S):
            if not table.recv_act[t, s]:
                continue
            m = int(table.recv_m[t, s])
            if table.recv_fin[t, s]:
                out[m] = wire[s]
            else:
                inbox[s][(m, int(table.recv_c[t, s]))] = wire[s]
        # 2. run every active stage's scheduled cell, 3. ship downstream
        wire = [None] * S
        for s in range(S):
            if not table.run_act[t, s]:
                continue
            m, c = int(table.run_m[t, s]), int(table.run_c[t, s])
            x_in = (x_micro[m].to(stages[s]) if c == 0 and s == 0
                    else inbox[s].pop((m, c)))
            dst = (s + 1) % S
            wire[dst] = block_fn(cells[(s, c)], x_in).to(stages[dst])
    missing = [m for m, y in enumerate(out) if y is None]
    if missing or any(inbox):
        raise RuntimeError(f"time table left microbatches {missing} unfinished")
    return torch.stack(out)


def reference_apply(params: Any, x_micro: torch.Tensor, block_fn: Callable
                    ) -> torch.Tensor:
    """Sequential oracle: every block in (chunk, stage) order."""
    leaf = _first_leaf(params)
    S, C = leaf.shape[0], leaf.shape[1]

    def one(x):
        for c in range(C):
            for s in range(S):
                x = block_fn(_tree_map(lambda a: a[s, c], params), x)
        return x

    return torch.stack([one(x) for x in x_micro])


def emit_pipeline_events(
    events: list[TraceEvent],
    table: TimeTable,
    *,
    ts: float,
    wall: float,
    bwd_cost: float = 2.0,
    step_idx: int = 0,
) -> None:
    """Synthesize per-(microbatch, stage, F/B) MegaScan events from the static
    dispatch table, scaled into a measured step's [ts, ts+wall] window.

    The forward traversal follows the table directly; the backward pipeline is
    autograd's exact mirror (it replays the ticks in reverse), so its events
    are the reversed table stretched by ``bwd_cost``.  The chrome export then
    shows the schedule's bubble structure — one pid row per stage — without
    instrumenting the executor.
    """
    run_act = np.asarray(table.run_act)
    run_m = np.asarray(table.run_m)
    run_c = np.asarray(table.run_c)
    T, S = run_act.shape
    tick = max(wall, 1e-9) / (T * (1.0 + bwd_cost))
    fwd_span = T * tick
    for t in range(T):
        for s in range(S):
            if not run_act[t, s]:
                continue
            m, c = int(run_m[t, s]), int(run_c[t, s])
            args = {"mb": m, "chunk": c, "stage": s, "step": step_idx}
            events.append(TraceEvent(
                "pp_F", s, ts + t * tick, tick, "compute",
                {**args, "phase": "F"},
            ))
            events.append(TraceEvent(
                "pp_B", s,
                ts + fwd_span + (T - 1 - t) * bwd_cost * tick,
                bwd_cost * tick, "compute",
                {**args, "phase": "B"},
            ))


def _cell_backward(block_fn, cell: Any, x: torch.Tensor, y: torch.Tensor | None,
                   residuals, ct: torch.Tensor, decoupled):
    """One cell's backward: ``(cell grads, input grad)`` for the output
    gradient ``ct``.  Without MegaFBD ``y`` is the output with its graph;
    with it, ``decoupled.bwd`` reads ``residuals``, those of the forward
    this process rebuilt from the cell's input."""
    if decoupled is None:
        flat: list[torch.Tensor] = []
        tree_map(flat.append, cell)
        grads = iter(torch.autograd.grad(y, [*flat, x], ct))
        return tree_map(lambda _: next(grads), cell), next(grads)
    g = decoupled.bwd({"cell": cell, "x": x}, {}, residuals, ct)
    return g["cell"], g["x"]


def pipeline_ranks_apply(
    cells: dict[tuple[int, int], Any],
    x_micro: list[torch.Tensor] | None,
    table: TimeTable,
    *,
    ranks: list[int],
    stage: int,
    block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    act_shape: tuple[int, ...],
    act_dtype: torch.dtype,
    device: torch.device,
    head: Callable[[list[torch.Tensor]], list[torch.Tensor]] | None = None,
    fbd: bool = False,
) -> tuple[dict[int, torch.Tensor], dict[int, Any]]:
    """The pipelined forward and backward of this process's stage, every
    stage a process (``ranks[s]``, the global rank of stage ``s`` in this
    process's line; ``stage`` this process's).

    ``cells[(s, c)]`` holds the parameters of cell ``(s, c)`` as leaves of
    their own (each a detached view of this process's part of its leaf),
    for this stage and, with ``fbd``, the stage before it, whose backward
    this process runs.  Stage 0 passes ``x_micro`` (each microbatch's input,
    ``act_shape``) and ``head``, which takes the final outputs (leaves that
    require grad), runs the loss and its backward and returns their
    gradients.  Sends and receives follow the table on every rank in the
    same order, tick by tick (:func:`repro_torch.parallel.dist.exchange`).
    Returns ``(input gradients {m: dx} on stage 0, {c: cell grads summed
    over the microbatches in float32} of the stage whose backward ran
    here)``.
    """
    from repro_torch.core.fbd.decouple import make_decoupled_step
    from repro_torch.parallel.dist import exchange

    S, T = len(ranks), table.steps
    me = stage
    prev, nxt = ranks[(me - 1) % S], ranks[(me + 1) % S]
    C = 1 + max(c for _, c in cells)
    n_micro = int(table.run_act[:, me].sum()) // C
    decoupled = (make_decoupled_step(lambda p, b: block_fn(p["cell"], p["x"]))
                 if fbd else None)
    empty = lambda: torch.empty(act_shape, dtype=act_dtype, device=device)  # noqa: E731

    # ---- forward: run this stage's cells, hand each output on
    inbox: dict[tuple[int, int], torch.Tensor] = {}
    out: list[torch.Tensor | None] = [None] * n_micro
    saved: dict[tuple[int, int], tuple] = {}
    pending = None
    for t in range(T):
        if table.recv_act[t, me]:
            m = int(table.recv_m[t, me])
            if table.recv_fin[t, me]:
                out[m] = pending.requires_grad_(True)
            else:
                inbox[(m, int(table.recv_c[t, me]))] = pending
            pending = None
        sends = []
        if table.run_act[t, me]:
            m, c = int(table.run_m[t, me]), int(table.run_c[t, me])
            x_in = x_micro[m] if (me == 0 and c == 0) else inbox.pop((m, c))
            if fbd:
                # the backward process rebuilds the graph: no graph here
                with torch.no_grad():
                    y = block_fn(cells[(me, c)], x_in)
                saved[(m, c)] = x_in.detach()
            else:
                x = x_in.detach().requires_grad_(True)
                y = block_fn(cells[(me, c)], x)
                saved[(m, c)] = (x, y)
            sends.append((y, nxt))
        recvs = []
        if t + 1 < T and table.recv_act[t + 1, me]:
            pending = empty()
            recvs.append((pending, prev))
        exchange(sends, recvs)
    if any(inbox) or (me == 0 and any(o is None for o in out)):
        raise RuntimeError("time table left microbatches unfinished")

    # ---- the head (stage 0): the loss and the final outputs' gradients
    q = (me - 1) % S if fbd else me  # the stage whose backward runs here
    grad_in: dict[tuple[int, int], torch.Tensor] = {}
    grad_out: dict[tuple[int, int], torch.Tensor] = {}
    fin_grads: list[torch.Tensor] = []
    if me == 0:
        fin_grads = head(out)
        if fbd:  # the last stage's backward runs here: its gradients stay
            for m, g in enumerate(fin_grads):
                grad_in[(m, C - 1)] = g

    # ---- backward: the mirrored table, this process's cells of stage q
    dx_micro: dict[int, torch.Tensor] = {}
    cell_grads: dict[int, Any] = {}
    for t in reversed(range(T)):
        ran_q = bool(table.run_act[t, q])
        mq, cq = int(table.run_m[t, q]), int(table.run_c[t, q])
        x = res = y = None
        if fbd:
            # the forward's process hands its cell's input on; the forward
            # rebuilt from it here saves what the forward would have (the
            # cell's forward is deterministic)
            mine = saved.pop((int(table.run_m[t, me]), int(table.run_c[t, me])),
                             None) if table.run_act[t, me] else None
            x = empty() if ran_q else None
            exchange([] if mine is None else [(mine, nxt)],
                     [(x, prev)] if ran_q else [])
            if ran_q:
                x.requires_grad_(True)
                _, res = decoupled.fwd({"cell": cells[(q, cq)], "x": x}, {})
        elif ran_q:
            x, y = saved.pop((mq, cq))
        sends, recvs = [], []
        if ran_q:
            g_cell, dx = _cell_backward(block_fn, cells[(q, cq)], x, y, res,
                                        grad_in.pop((mq, cq)), decoupled)
            # the microbatches' parts summed in float32, as one product
            # over all of them would sum them before its one rounding
            acc = cell_grads.get(cq)
            cell_grads[cq] = (tree_map(lambda g: g.float(), g_cell) if acc is None
                              else tree_map(torch.add, acc, g_cell))
            if q == 0 and cq == 0:
                if me == 0:
                    dx_micro[mq] = dx
                else:
                    sends.append((dx, ranks[0]))
            else:
                grad_out[(mq, cq)] = dx
        if fbd and me == 0 and table.run_act[t, 0] and table.run_c[t, 0] == 0:
            m0 = int(table.run_m[t, 0])
            dx_micro[m0] = empty()
            recvs.append((dx_micro[m0], ranks[1 % S]))
        # the mirror of the deposit at t: its gradient goes back to the
        # process that runs the backward of the stage that sent it
        if table.recv_act[t, q]:
            m = int(table.recv_m[t, q])
            if not table.recv_fin[t, q]:
                sends.append((grad_out.pop((m, int(table.recv_c[t, q]))), prev))
            elif not fbd:
                sends.append((fin_grads[m], prev))
        if t > 0 and table.run_act[t - 1, q] and not (
                fbd and table.recv_fin[t, (q + 1) % S]):
            key = (int(table.run_m[t - 1, q]), int(table.run_c[t - 1, q]))
            grad_in[key] = empty()
            recvs.append((grad_in[key], nxt))
        exchange(sends, recvs)
    if grad_in or grad_out:
        raise RuntimeError("time table left gradients undelivered")
    return dx_micro, cell_grads

