"""MegaFBD communication coordinator (§4.2) — faithful bit-vector protocol.

Multiple worker threads (virtual ranks) share one GPU/control thread.  A
collective may launch only once *every* member has posted the same request;
the coordinator tracks readiness in a bit-vector table of shape
[n_groups x n_virtual_ranks] (O(G) state), aligns the flattened table across
control threads with a bitwise-OR all-reduce, and launches ready groups in
ascending group order (no contention / starvation).

``run_fcfs`` models the naive alternative the paper warns about: each control
thread launches its workers' requests first-come-first-served; launching a
not-yet-ready collective blocks the whole control thread — with unlucky
arrival interleavings this deadlocks (test_fbd reproduces it).

A copy of ``repro.core.fbd.coordinator`` (numpy only); the port keeps its
own, as it imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class CollectiveRequest:
    group_id: int
    vrank: int


@dataclass
class ThreadProgram:
    """A virtual rank's ordered list of collectives (it blocks on each)."""
    vrank: int
    control: int               # hosting control thread (physical GPU)
    group_ids: list[int] = field(default_factory=list)


class BitVectorCoordinator:
    def __init__(self, groups: dict[int, tuple[int, ...]], n_vranks: int,
                 n_controls: int):
        self.groups = groups
        self.n_vranks = n_vranks
        self.n_controls = n_controls
        # one table per control thread; alignment ORs them together
        self.tables = np.zeros((n_controls, len(groups), n_vranks), dtype=bool)
        self.gids = sorted(groups)
        self.gid_row = {g: i for i, g in enumerate(self.gids)}
        self.expected = np.zeros((len(groups), n_vranks), dtype=bool)
        for g, members in groups.items():
            for v in members:
                self.expected[self.gid_row[g], v] = True

    # step 1: registration
    def register(self, control: int, req: CollectiveRequest) -> None:
        self.tables[control, self.gid_row[req.group_id], req.vrank] = True

    # step 2: alignment (bitwise-OR all-reduce over the flattened tensor)
    def align(self) -> np.ndarray:
        return np.logical_or.reduce(self.tables, axis=0)

    # step 3+4: readiness check, ordered execution
    def ready_groups(self) -> list[int]:
        merged = self.align()
        out = []
        for g in self.gids:  # ascending group order
            row = self.gid_row[g]
            if (merged[row] & self.expected[row]).sum() == self.expected[row].sum() \
                    and self.expected[row].any():
                out.append(g)
        return out

    def complete(self, group_id: int) -> None:
        row = self.gid_row[group_id]
        self.tables[:, row, :] = False
        self.expected[row, :] = False  # single-shot instance

    @property
    def state_bytes(self) -> int:
        return self.tables.size  # O(n_groups) per control thread


def run_with_coordinator(
    programs: list[ThreadProgram],
    groups: dict[int, tuple[int, ...]],
    n_controls: int,
    max_rounds: int = 10_000,
) -> list[int]:
    """Simulate the protocol; returns the global launch order.  Raises
    RuntimeError on no-progress (cannot happen for consistent programs)."""
    n_vranks = len(programs)
    coord = BitVectorCoordinator(groups, n_vranks, n_controls)
    cursor = {p.vrank: 0 for p in programs}
    by_vrank = {p.vrank: p for p in programs}
    launched: list[int] = []
    total = sum(len(p.group_ids) for p in programs)
    done = 0
    rounds = 0
    while done < total:
        rounds += 1
        if rounds > max_rounds:
            raise RuntimeError("coordinator made no progress")
        # every blocked worker registers its next collective
        for p in programs:
            c = cursor[p.vrank]
            if c < len(p.group_ids):
                coord.register(p.control, CollectiveRequest(p.group_ids[c], p.vrank))
        ready = coord.ready_groups()
        if not ready:
            raise RuntimeError(
                f"stuck: no group ready (launched={launched}); inconsistent programs"
            )
        for g in ready:
            launched.append(g)
            coord.complete(g)
            for v in groups[g]:
                cursor[v] += 1
                done += 1
    return launched


def run_fcfs(
    programs: list[ThreadProgram],
    groups: dict[int, tuple[int, ...]],
    n_controls: int,
    arrival_seed: int = 0,
    max_steps: int = 10_000,
) -> list[int] | None:
    """Naive launcher: each control thread launches its workers' requests in
    arrival order; a launch blocks the control thread until all members'
    controls have also launched that group.  Returns the launch order, or
    None when it deadlocks."""
    rng = np.random.default_rng(arrival_seed)
    cursor = {p.vrank: 0 for p in programs}
    # per control thread: queue of (vrank, group) in randomized arrival order
    queues: dict[int, list[int]] = {c: [] for c in range(n_controls)}
    members_ctrl = {
        g: {next(p.control for p in programs if p.vrank == v) for v in ms}
        for g, ms in groups.items()
    }
    blocked_on: dict[int, int | None] = {c: None for c in range(n_controls)}
    launched_by: dict[int, set[int]] = {g: set() for g in groups}
    order: list[int] = []
    total = sum(len(p.group_ids) for p in programs)
    done = 0

    for _ in range(max_steps):
        if done >= total:
            return order
        progressed = False
        # workers at the head of their program enqueue to their control
        for p in rng.permutation(len(programs)):
            prog = programs[p]
            c = cursor[prog.vrank]
            if c < len(prog.group_ids):
                g = prog.group_ids[c]
                if g not in queues[prog.control]:
                    queues[prog.control].append(g)
        for ctrl in range(n_controls):
            if blocked_on[ctrl] is None and queues[ctrl]:
                g = queues[ctrl].pop(0)   # FCFS: take the first arrival
                blocked_on[ctrl] = g
                launched_by[g].add(ctrl)
                progressed = True
        # a collective completes when every member control has launched it
        for g, ctrls in list(launched_by.items()):
            if ctrls and ctrls == members_ctrl[g]:
                order.append(g)
                for v in groups[g]:
                    cursor[v] += 1
                    done += 1
                for c2 in ctrls:
                    blocked_on[c2] = None
                launched_by[g] = set()
                members_ctrl[g] = set()  # single-shot
                progressed = True
        if not progressed:
            return None  # deadlock: every control blocked on a not-ready op
    return None
