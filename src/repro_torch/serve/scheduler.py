"""Continuous-batching scheduler: admission, eviction, preemption-by-recompute.

Copied from ``repro.serve.scheduler``: pure host-side bookkeeping (numpy
block tables, a python free list) split from the engine, so the policy is the
JAX package's to the letter, speculative capacity (``ensure_capacity``'s
per-slot write counts), rewind (``trim_blocks``) and the router's migration
entry points (``adopt``/``release_request``) included.

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

    The engine-path knobs keep the JAX package's names and meanings.
    ``decode_path``: ``"paged"`` decodes every slot in one batched forward
    straight against the pool (K3 on the card); ``"gathered"`` is the
    oracle, the pool gathered into a dense view, one B=1 forward a slot,
    then the written block scattered back; ``"auto"`` is paged unless a
    MegaScope collector is live.  ``prefill_path``: ``"flash"`` streams the
    right-padded prompt through the flash-prefill kernel (K4) into the
    slot's blocks, ``"dense"`` prefills a dense one-row cache and scatters
    it; ``"auto"`` is flash wherever it is legal (the paged path and an
    attention-only family).  Speculative decoding (``spec_decode``): a
    host-side drafter proposes up to ``spec_k`` tokens a request and one
    batched ``spec_k + 1``-token forward (K4) verifies every slot's; the
    per-request draft length adapts to the acceptance, down to 0 (re-probed
    every ``spec_retry`` steps).  Chunked prefill (``chunked_prefill``):
    prompts longer than ``chunk_len`` (0 = ``2 * block_size``; else a
    multiple of it) stream into the pool one chunk a tick through K4, decode
    ticks of other slots between them.  Both need the paged path and an
    attention-only family.
    """

    num_slots: int = 4
    block_size: int = 16
    num_blocks: int = 65           # physical blocks incl. the reserved null
    max_blocks_per_slot: int = 16  # block-table width; max_len = this * bs
    max_prefills_per_step: int = 1 # prefill/decode interleaving bound
    decode_path: str = "auto"      # auto | paged | gathered
    prefill_path: str = "auto"     # auto | flash | dense
    spec_decode: bool = False      # verify spec_k drafts a slot a step
    spec_k: int = 4                # max draft tokens a request a step
    spec_ngram_max: int = 4        # prompt-lookup drafter: longest suffix
    spec_ngram_min: int = 1        #   n-gram tried, shortest accepted
    spec_retry: int = 16           # steps between draft re-probes at len 0
    chunked_prefill: bool = False  # stream long prompts chunk by chunk
    chunk_len: int = 0             # 0 = 2 * block_size; else a multiple of it

    def __post_init__(self) -> None:
        if self.chunk_len < 0:
            raise ValueError(f"chunk_len must be >= 0, got {self.chunk_len}")
        if self.chunk_len and self.chunk_len % self.block_size != 0:
            raise ValueError(
                f"chunk_len={self.chunk_len} must be a multiple of the "
                f"prefill bucket size (block_size={self.block_size})"
            )

    @property
    def resolved_chunk_len(self) -> int:
        return self.chunk_len or 2 * self.block_size

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

    # -------------------------------------------------- migration intake
    def adopt(self, req: Request, pos: int, last_tok: int) -> tuple[int, list[int]] | None:
        """Take over a request mid-flight (disaggregated prefill hand-off):
        claim a free slot plus enough blocks to cover ``pos`` already-written
        cache positions and register the request as RUNNING — the imported
        KV blocks land where the returned ``phys`` list says.  Returns
        ``(slot, phys)``, or ``None`` when no slot/blocks are free (the
        router retries next tick)."""
        if req.rid in self.requests:
            raise ValueError(f"duplicate rid {req.rid}")
        slot = next((s for s, r in enumerate(self.slots) if r is None), None)
        if slot is None:
            return None
        phys = self.allocator.try_alloc(blocks_for(pos, self.cfg.block_size))
        if phys is None:
            return None
        self.requests[req.rid] = req
        self.slots[slot] = req.rid
        self.blocks[slot] = list(phys)
        self.pos[slot] = pos
        self.last_tok[slot] = last_tok
        self.tables[slot, :] = 0
        self.tables[slot, : len(phys)] = phys
        self._seq += 1
        self._admit_seq[slot] = self._seq
        req.status = RequestStatus.RUNNING
        return slot, list(phys)

    def release_request(self, rid: int) -> None:
        """Drop a request entirely (migrated away): free its slot/blocks and
        forget it — unlike preemption it is NOT requeued here, and unlike
        eviction it is not marked finished (the adopting replica owns its
        lifecycle from now on)."""
        slot = next((s for s, r in enumerate(self.slots) if r == rid), None)
        if slot is None:
            raise ValueError(f"rid {rid} not active (cannot release)")
        self._release(slot)
        del self.requests[rid]

    # ----------------------------------------------------------- capacity
    def ensure_capacity(self, extra: dict[int, int] | None = None) -> list[int]:
        """Grow each active slot's block table to cover its next ``e`` write
        positions (``e = extra.get(slot, 1)``; speculative verification
        writes ``1 + draft_len`` positions at once), preempting
        youngest-admitted slots when the pool runs dry.  Returns the rids
        preempted this call."""
        preempted: list[int] = []
        for slot in sorted(self.active_slots(), key=lambda s: self._admit_seq[s]):
            if self.slots[slot] is None:       # victim of an earlier preempt
                continue
            e = max(extra.get(slot, 1) if extra else 1, 1)
            want = (self.pos[slot] + e - 1) // self.cfg.block_size + 1
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
        """A decode/verify step wrote K/V at ``pos .. pos + n - 1``; move the
        write cursor past the committed prefix."""
        self.pos[slot] += n

    def trim_blocks(self) -> None:
        """Rewind speculative over-allocation: free each active slot's
        blocks past the committed high-water mark ``ceil(pos / block_size)``
        and re-point their table entries at the null block.  Rejected verify
        writes live only in the freed region or beyond ``kv_len``'s mask, so
        the freed blocks carry no live data."""
        for slot in self.active_slots():
            keep = max(blocks_for(self.pos[slot], self.cfg.block_size), 1)
            drop = self.blocks[slot][keep:]
            if drop:
                self.allocator.free(drop)
                del self.blocks[slot][keep:]
                self.tables[slot, keep:] = 0

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
