"""Paged KV cache: a fixed-size physical block pool + per-slot block tables.

Counterpart of ``repro.serve.paged_cache``.  The time axis of every attention
cache is cut into fixed-size blocks that live in one shared physical pool; a
slot owns an ordered *block table* of pool indices, and slots with very
different lengths share the pool densely.  Block 0 is the *null block*:
padding entries of every block table point at it, so writes of inactive slots
and padded positions land there harmlessly and every read masks them.

The pool mirrors the model's cache tree (``lm.init_cache``), each leaf
stacked over its segment's groups.  Attention ``k``/``v`` are *paged*
leaves, bfloat16 ``[n, num_blocks, bs, K, dh]`` (MLA's latent ``ckv`` and
``kpe``, ``[n, num_blocks, bs, width]``, have no head axis; every method
below takes a leaf's trailing axes as they come); the recurrent families'
state (RWKV-6's ``x_prev``/``wkv``, Griffin's ``conv``/``h``) are
*slot-state* leaves, float32 ``[n, num_slots, ...]``, a row per slot used in
place.  ``PagedKVCache.paged`` tells them apart as JAX's does.  (The JAX
package widens bfloat16 paged leaves to float32 on its CPU backend to keep
scatters in place; PyTorch updates a bfloat16 tensor in place on any
device.)  ``gather`` and ``scatter_decode`` serve the gathered decode
path; ``export_slot`` and ``import_slot`` move one slot's cache state
between pools, the router's disaggregated prefill -> decode hand-off.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


class PoolExhausted(RuntimeError):
    """No free physical blocks — the scheduler should preempt."""


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` fixed-size physical blocks.

    Block ids ``[reserved, num_blocks)`` are allocatable; ``[0, reserved)``
    (the null block) never leave the allocator.
    """

    def __init__(self, num_blocks: int, reserved: int = 1):
        if num_blocks <= reserved:
            raise ValueError(f"need > {reserved} blocks, got {num_blocks}")
        self.num_blocks = num_blocks
        self.reserved = reserved
        # LIFO free list: recently-freed blocks are reused first (warm)
        self._free: list[int] = list(range(num_blocks - 1, reserved - 1, -1))
        self._held: set[int] = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_held(self) -> int:
        return len(self._held)

    def alloc(self, n: int = 1) -> list[int]:
        if n > len(self._free):
            raise PoolExhausted(f"want {n} blocks, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        self._held.update(out)
        return out

    def try_alloc(self, n: int = 1) -> list[int] | None:
        if n > len(self._free):
            return None
        return self.alloc(n)

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if b not in self._held:
                raise ValueError(f"block {b} not held (double free?)")
            self._held.remove(b)
            self._free.append(b)


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache positions."""
    return -(-n_tokens // block_size)


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= ``n``: the bucketing of prefill lengths and of
    the decode-table high-water mark, as in the JAX package."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def pow2_segments(n: int) -> list[int]:
    """Descending binary decomposition of ``n`` (13 -> [8, 4, 1]): the exact
    segment widths the recurrent families' prefill driver runs."""
    if n <= 0:
        raise ValueError(f"need n >= 1, got {n}")
    return [1 << b for b in range(n.bit_length() - 1, -1, -1) if n >> b & 1]


@dataclass(frozen=True)
class PoolSpec:
    num_slots: int
    num_blocks: int          # physical blocks incl. the reserved null block
    block_size: int
    max_blocks: int          # block-table width per slot


class PagedKVCache:
    """The physical pool of a model: ``self.pool`` is ``lm.init_pool``'s
    tree on ``device`` (paged attention leaves and slot-state leaves),
    written in place by the engine steps; ``self.paged`` is its leaf-kind
    tree (True for a paged leaf), equal to JAX's ``PagedKVCache.paged``."""

    def __init__(self, cfg: ModelConfig, spec: PoolSpec, device: torch.device):
        self.cfg = cfg
        self.spec = spec
        self.paged = lm.paged_flags(cfg)
        self.pool = lm.init_pool(cfg, spec.num_blocks, spec.block_size, device,
                                 num_slots=spec.num_slots)

    def gather(self, pool: dict, tables: torch.Tensor) -> dict:
        """The dense decode cache of every slot, a copy: paged leaves become
        ``[n, S, M * bs, *feat]`` through ``tables [S, M]`` (padding entries
        at the null block), slot-state leaves pass through as they are (the
        pool's own tensors, already a row per slot)."""
        S, M = tables.shape
        idx = tables.reshape(-1).long()

        def leaf(p, paged):
            if not paged:
                return p
            return p[:, idx].reshape(p.shape[0], S, M * p.shape[2], *p.shape[3:])

        return lm.tree_map(leaf, pool, self.paged)

    def scatter_decode(self, pool: dict, dense: dict, tables: torch.Tensor,
                       pos: torch.Tensor) -> None:
        """Write back, in place, the one block each slot touched at ``pos``
        (its write position this step): ``dense``'s block ``pos // bs`` of
        slot ``s`` goes to pool block ``tables[s, pos // bs]``.  Slot-state
        leaves are ``pool``'s own tensors in ``dense`` (see :meth:`gather`),
        already written."""
        S = tables.shape[0]
        bs = self.spec.block_size
        tb = pos.long() // bs                                        # [S]
        phys = tables.long()[torch.arange(S, device=tables.device), tb]
        cols = (tb * bs)[:, None] + torch.arange(bs, device=tb.device)[None]
        rows = torch.arange(S, device=tb.device)[:, None]

        def leaf(p, d, paged):
            if paged:
                p[:, phys] = d[:, rows, cols]                     # [n, S, bs, f]
            return p

        lm.tree_map(leaf, pool, dense, self.paged)

    def export_slot(self, pool: dict, phys: torch.Tensor, slot: int) -> dict:
        """One slot's cache state out of ``pool`` as a self-contained bundle,
        a copy (the disaggregation hand-off unit): paged leaves become
        ``[n, n_blk, bs, *feat]``, the ``phys`` [n_blk] blocks in table
        order; slot-state leaves become ``[n, *feat]``, the slot's row.
        ``phys`` may be padded with null-block entries: those rows carry
        whatever the null block holds and are ignored on import."""
        idx = phys.long()

        def leaf(p, paged):
            return p.index_select(1, idx) if paged else p[:, slot].clone()

        return lm.tree_map(leaf, pool, self.paged)

    def import_slot(self, pool: dict, bundle: dict, phys: torch.Tensor,
                    slot: int) -> None:
        """Deposit an :meth:`export_slot` bundle into ``pool`` in place, cast
        to the pool's dtype: paged leaves at the ``phys`` blocks, slot-state
        leaves at row ``slot``.  Padding entries of ``phys`` must point at
        the null block, where the extra writes land harmlessly (as the
        decode writes of inactive slots do)."""
        idx = phys.long()

        def leaf(p, b, paged):
            if paged:
                p[:, idx] = b.to(p.dtype)
            else:
                p[:, slot] = b.to(p.dtype)
            return p

        lm.tree_map(leaf, pool, bundle, self.paged)

    def scatter_prefill(self, pool: dict, filled: dict, slot: int,
                        phys: torch.Tensor) -> None:
        """Deposit a freshly prefilled one-row dense cache (``cache_len`` a
        block multiple) into ``pool`` in place: paged leaves into the
        ``phys`` [n_blk] blocks (padding entries at the null block), state
        leaves into row ``slot``."""
        bs = self.spec.block_size
        n_blk = phys.shape[0]
        idx = phys.long()

        def leaf(p, f, paged):
            if paged:
                p[:, idx] = f[:, 0].reshape(p.shape[0], n_blk, bs, *p.shape[3:])
            else:
                p[:, slot] = f[:, 0]
            return p

        lm.tree_map(leaf, pool, filled, self.paged)
