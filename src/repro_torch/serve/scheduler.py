"""Continuous-batching scheduler: admission, eviction, preemption-by-recompute.

Copied from ``repro.serve.scheduler``: pure host-side bookkeeping (numpy
block tables, a python free list) split from the engine, so the policy is the
JAX package's to the letter.  The migration (``adopt``/``release_request``)
and speculative rewind (``trim_blocks``) entry points arrive with the router
and speculative-decoding slices.

Invariants:
  * every active slot holds exactly ``ceil(pos / block_size)`` physical
    blocks, except transiently inside ``ensure_capacity`` which grows it to
    cover the next write position;
  * block-table padding entries point at the reserved null block 0;
  * preemption frees *all* of a victim's blocks and requeues it at the head
    of the waiting line with its generated tokens folded into the prompt —
    greedy decode recomputes to the identical continuation.

Policy knobs: admission is FIFO over arrived requests; capacity priority is
oldest-admitted-first; the preemption victim is the youngest-admitted active
slot (LIFO, so the request closest to done keeps running).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.serve.paged_cache import BlockAllocator, blocks_for
from repro_torch.serve.request import Request, RequestStatus


@dataclass(frozen=True)
class ServeConfig:
    """Static serving-engine configuration (pool geometry + policy knobs).

    ``num_slots`` concurrent sequences share ``num_blocks`` physical KV
    blocks of ``block_size`` tokens (block 0 is the reserved null block);
    ``max_blocks_per_slot`` is the block-table width, so one sequence spans
    at most ``max_len = max_blocks_per_slot * block_size`` positions.

    The engine-path knobs keep the JAX package's names.  The port runs the
    paged decode path, with flash prefill for an attention-only family and
    the dense segment prefill for a recurrent one (what ``"auto"`` picks on
    the card); selecting the gathered path, the dense prefill of an
    attention-only family, speculative decoding or chunked prefill raises
    ``NotImplementedError`` naming the later slice (for a recurrent family
    the last two raise ``ValueError`` as in JAX: its state cannot roll back
    or be split).
    """

    num_slots: int = 4
    block_size: int = 16
    num_blocks: int = 65           # physical blocks incl. the reserved null
    max_blocks_per_slot: int = 16  # block-table width; max_len = this * bs
    max_prefills_per_step: int = 1 # prefill/decode interleaving bound
    decode_path: str = "auto"      # auto | paged (gathered: later slice)
    prefill_path: str = "auto"     # auto | flash | dense (recurrent families)
    spec_decode: bool = False      # later slice
    chunked_prefill: bool = False  # later slice

    @property
    def max_len(self) -> int:
        return self.max_blocks_per_slot * self.block_size

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1


@dataclass
class Admission:
    slot: int
    rid: int
    tokens: list[int]              # prompt to prefill (recompute incl.)
    phys: list[int]                # freshly-allocated physical blocks
    is_recompute: bool


class Scheduler:
    """Host-side serving policy: slot assignment, block accounting, and the
    admission / capacity / eviction decisions one ``MegaServe.step()`` tick
    is made of.  Owns the numpy block tables the engine steps read."""

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        self.allocator = BlockAllocator(cfg.num_blocks, reserved=1)
        self.requests: dict[int, Request] = {}
        self.waiting: list[int] = []
        S, M = cfg.num_slots, cfg.max_blocks_per_slot
        self.slots: list[int | None] = [None] * S
        self.blocks: list[list[int]] = [[] for _ in range(S)]
        self.pos: list[int] = [0] * S
        self.last_tok: list[int] = [0] * S
        self.tables = np.zeros((S, M), np.int32)
        self._admit_seq = [0] * S
        self._seq = 0

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        """Queue a request for admission; rejects requests whose worst-case
        footprint can never fit a slot (prompt + budget vs table width)."""
        worst = blocks_for(req.prompt_len + req.max_new, self.cfg.block_size)
        if worst > min(self.cfg.usable_blocks, self.cfg.max_blocks_per_slot):
            raise ValueError(
                f"request {req.rid}: needs {worst} blocks, pool/slot caps are "
                f"{self.cfg.usable_blocks}/{self.cfg.max_blocks_per_slot}"
            )
        if req.rid in self.requests:
            raise ValueError(f"duplicate rid {req.rid}")
        self.requests[req.rid] = req
        self.waiting.append(req.rid)

    # ---------------------------------------------------------- admission
    def admit(self, now: float) -> list[Admission]:
        """FIFO-admit arrived requests into free slots while blocks last,
        bounded by ``max_prefills_per_step``."""
        out: list[Admission] = []
        while len(out) < self.cfg.max_prefills_per_step:
            slot = next((s for s, r in enumerate(self.slots) if r is None), None)
            if slot is None:
                break
            rid = next(
                (r for r in self.waiting if self.requests[r].arrival <= now), None
            )
            if rid is None:
                break
            req = self.requests[rid]
            tokens = req.recompute_prompt
            phys = self.allocator.try_alloc(blocks_for(len(tokens), self.cfg.block_size))
            if phys is None:
                break
            self.waiting.remove(rid)
            self.slots[slot] = rid
            self.blocks[slot] = list(phys)
            self.pos[slot] = len(tokens)
            self.tables[slot, :] = 0
            self.tables[slot, : len(phys)] = phys
            self._seq += 1
            self._admit_seq[slot] = self._seq
            req.status = RequestStatus.RUNNING
            if req.t_admitted is None:
                req.t_admitted = now
            out.append(Admission(slot, rid, tokens, list(phys),
                                 is_recompute=req.n_preemptions > 0))
        return out

    # ----------------------------------------------------------- capacity
    def ensure_capacity(self) -> list[int]:
        """Grow each active slot's block table to cover its next write
        position, preempting youngest-admitted slots when the pool runs dry.
        Returns the rids preempted this call."""
        preempted: list[int] = []
        for slot in sorted(self.active_slots(), key=lambda s: self._admit_seq[s]):
            if self.slots[slot] is None:       # victim of an earlier preempt
                continue
            want = self.pos[slot] // self.cfg.block_size + 1
            while len(self.blocks[slot]) < want:
                got = self.allocator.try_alloc(1)
                if got is not None:
                    b = got[0]
                    self.tables[slot, len(self.blocks[slot])] = b
                    self.blocks[slot].append(b)
                    continue
                # LIFO victim: the youngest-admitted active slot — possibly
                # the growing slot itself, which then waits its turn back
                # in the queue rather than stealing from an older request
                victims = [
                    s for s in self.active_slots() if self.slots[s] is not None
                ]
                victim = max(victims, key=lambda s: self._admit_seq[s])
                preempted.append(self.preempt(victim))
                if victim == slot:
                    break
        return preempted

    def preempt(self, slot: int) -> int:
        """Evict a running request: free all its blocks and requeue it at the
        head of the waiting line with generated tokens folded into the
        prompt (preemption-by-recompute).  Returns the rid."""
        rid = self.slots[slot]
        assert rid is not None
        req = self.requests[rid]
        req.status = RequestStatus.WAITING
        req.n_preemptions += 1
        self._release(slot)
        self.waiting.insert(0, rid)
        return rid

    # ------------------------------------------------------------- decode
    def active_slots(self) -> list[int]:
        return [s for s, r in enumerate(self.slots) if r is not None]

    def record_token(self, slot: int, tok: int, now: float) -> None:
        """Append one generated token for the request in ``slot``."""
        rid = self.slots[slot]
        assert rid is not None
        req = self.requests[rid]
        req.generated.append(tok)
        if req.t_first_token is None:
            req.t_first_token = now
        self.last_tok[slot] = tok

    def advance(self, slot: int, n: int = 1) -> None:
        """A decode step wrote K/V at ``pos .. pos + n - 1``; move the write
        cursor past it."""
        self.pos[slot] += n

    def evict_finished(self, now: float) -> list[int]:
        out = []
        for slot in self.active_slots():
            req = self.requests[self.slots[slot]]
            if req.done:
                req.status = RequestStatus.FINISHED
                req.t_finished = now
                out.append(req.rid)
                self._release(slot)
        return out

    def _release(self, slot: int) -> None:
        self.allocator.free(self.blocks[slot])
        self.blocks[slot] = []
        self.slots[slot] = None
        self.pos[slot] = 0
        self.last_tok[slot] = 0
        self.tables[slot, :] = 0

    # -------------------------------------------------------------- state
    @property
    def all_done(self) -> bool:
        return not self.waiting and not self.active_slots() and all(
            r.status is RequestStatus.FINISHED for r in self.requests.values()
        )

    def next_arrival(self) -> float | None:
        if not self.waiting:
            return None
        return min(self.requests[r].arrival for r in self.waiting)
