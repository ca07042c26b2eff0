"""Serving step factories: static lockstep steps and MegaServe's engine steps.

Counterparts of ``repro.serve.engine``'s factories.  PyTorch runs eagerly, so
there is nothing to compile and no per-width executable; every step updates
its cache or pool in place (the JAX package jits the same steps with them
donated) and returns ``(logits, captures)``, where ``captures`` is the
forward's ``aux["captures"]`` (``{}`` when nothing was captured, always
without a ``collector``).

* ``make_prefill_step`` / ``make_decode_step``: static lockstep serving
  over a dense cache with one shared position (``StaticRunner``);
* ``make_paged_decode_step``, ``make_spec_verify_step``,
  ``make_chunk_prefill_step`` and ``make_flash_prefill_step``: one forward
  straight against the paged pool, at Q = 1 (K3 on the card), Q =
  ``spec_k + 1`` and Q = chunk over a cached prefix (K4), and the whole
  padded prompt from position 0 (K4); the batched steps' captures have the
  slot axis as the batch axis of every tag;
* ``make_seg_prefill``: one exact pow2 segment over a dense one-row cache
  (the recurrent families' prefill);
* ``make_slot_decode_step`` / ``make_slot_prefill``: the gathered path's
  oracle steps over the dense view, one B=1 forward a slot (JAX's
  ``jax.vmap`` of a B=1 forward), captures stacked on a leading slot axis.

``plain=True`` (on the paged and segment steps) builds a step over the
plain PyTorch attention and norm versions on any device: the teacher-forced
reference the kernels are held to on the card.  With a live collector, an
attention block of a paged step does not take the fused flash-prefill
branch (which never materialises the roped q and k its tags need) but the
generic one, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention.ops import PagedInfo
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.hooks import NULL_COLLECTOR, Collector
from repro_torch.serve.sampler import sample


def _check_servable(cfg: ModelConfig) -> None:
    if cfg.input_kind != "tokens":
        raise ValueError(f"{cfg.name}: continuous batching serves token archs")
    lm.segment_layout(cfg)  # raises for the families of later slices


# ---------------------------------------------------------------------------
# Static lockstep serving (one shared position)
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig,
                      collector: Collector = NULL_COLLECTOR) -> Callable:
    """Returns ``prefill(params, tokens [B, P], cache) -> (logits [B, V],
    captures)``: the prompts through ``lm.forward`` from position 0, filling
    the dense ``cache`` (``lm.init_cache``) in place; the logits are the last
    position's (JAX ``lm.prefill``)."""
    _check_servable(cfg)

    @torch.inference_mode()
    def prefill(params, tokens, cache):
        hidden, aux = lm.forward(cfg, params, tokens, cache=cache, cache_pos=0,
                                 collector=collector)
        return L.logits_fn(params, cfg, hidden[:, -1:])[:, 0], aux.get("captures", {})

    return prefill


def make_decode_step(cfg: ModelConfig, collector: Collector = NULL_COLLECTOR, *,
                     temperature: float = 0.0) -> Callable:
    """Returns ``decode(params, cache, tokens [B], pos) -> (logits [B, V],
    next_tok [B], captures)``: one token a row at the shared int ``pos``.
    The next token is ``sample(logits, temperature=...)`` without a
    generator, which is argmax whatever the temperature, as JAX's
    ``make_decode_step`` samples without a key (ROADMAP R7)."""
    _check_servable(cfg)

    @torch.inference_mode()
    def decode(params, cache, tokens, pos):
        hidden, aux = lm.forward(cfg, params, tokens.reshape(-1, 1), cache=cache,
                                 cache_pos=int(pos), collector=collector)
        logits = L.logits_fn(params, cfg, hidden)[:, 0]
        return logits, sample(logits, temperature=temperature), aux.get("captures", {})

    return decode


# ---------------------------------------------------------------------------
# MegaServe steps over the paged pool (per-slot positions)
# ---------------------------------------------------------------------------


def _pool_forward(cfg, params, pool, tables, tokens, pos, *, block_size, plain,
                  collector, prefill=False, q_start=None):
    paged = PagedInfo(tables=tables, block_size=block_size, prefill=prefill,
                      q_start=q_start, plain=plain)
    hidden, aux = lm.forward(cfg, params, tokens, pool=pool, cache_pos=pos,
                             paged=paged, collector=collector)
    return hidden, aux.get("captures", {})


def make_paged_decode_step(
    cfg: ModelConfig, collector: Collector = NULL_COLLECTOR, *,
    block_size: int, plain: bool = False,
) -> Callable:
    """Returns ``step(params, pool, tables [S, M] int32, tokens [S],
    pos [S] int32) -> (logits [S, V], captures)``: one batched decode over
    all slots.

    Slots ride the batch axis of a single ``lm.forward`` with per-slot
    positions; each slot's new K/V go into the pool block that owns ``pos``,
    and attention walks ``tables`` (which may be sliced to the live-block
    high-water mark), so per-step cost is O(live kv_len), not O(pool).
    Recurrent blocks carry every slot's state row in place: all ``S`` rows
    decode, and an idle slot's row drifts until an admission overwrites it.
    """
    _check_servable(cfg)

    @torch.inference_mode()
    def step(params, pool, tables, tokens, pos):
        hidden, caps = _pool_forward(cfg, params, pool, tables, tokens[:, None],
                                     pos, block_size=block_size, plain=plain,
                                     collector=collector)
        return L.logits_fn(params, cfg, hidden)[:, 0], caps

    return step


def make_spec_verify_step(
    cfg: ModelConfig, collector: Collector = NULL_COLLECTOR, *,
    block_size: int, plain: bool = False,
) -> Callable:
    """Returns ``step(params, pool, tables [S, M], tokens [S, Q], pos [S]) ->
    (logits [S, Q, V], captures)``: the speculative-decoding verify forward.
    Every slot scores its last committed token and its draft, right-padded
    to Q = ``spec_k + 1``, in one batched call through the flash-prefill
    branch (K4 at Q over each slot's cached prefix, no ``q_start``: the
    slots start at different positions).

    Row ``i`` is the prediction for the position after ``tokens[:, i]``, so
    it verifies draft token ``i + 1``.  K/V of all Q rows are written at
    ``pos + i``; rows past a slot's grown table reach go to the null block,
    and rejected rows' writes lie past the committed ``kv_len``, where every
    read masks them and later writes overwrite them."""
    _check_servable(cfg)

    @torch.inference_mode()
    def step(params, pool, tables, tokens, pos):
        hidden, caps = _pool_forward(cfg, params, pool, tables, tokens, pos,
                                     block_size=block_size, plain=plain,
                                     collector=collector, prefill=True)
        return L.logits_fn(params, cfg, hidden), caps

    return step


def make_chunk_prefill_step(
    cfg: ModelConfig, collector: Collector = NULL_COLLECTOR, *,
    block_size: int, plain: bool = False,
) -> Callable:
    """Returns ``step(params, pool, tables [1, M], tokens [1, C], pos [1],
    n_last) -> (last_logits [V], captures)``: one prompt chunk of C tokens
    written at ``pos .. pos + C - 1`` of the slot and attending causally over
    everything its table holds (K4 at Q = C over the cached prefix).
    ``n_last`` is the in-chunk index of the prompt's last real token: only
    the final chunk's logits matter.  Pad tokens of the final chunk write
    past the slot's ``kv_len``, where every read masks them."""
    _check_servable(cfg)

    @torch.inference_mode()
    def step(params, pool, tables, tokens, pos, n_last):
        hidden, caps = _pool_forward(cfg, params, pool, tables, tokens, pos,
                                     block_size=block_size, plain=plain,
                                     collector=collector, prefill=True)
        last = hidden[:, n_last:n_last + 1]
        return L.logits_fn(params, cfg, last)[0, 0], caps

    return step


def make_flash_prefill_step(
    cfg: ModelConfig, collector: Collector = NULL_COLLECTOR, *,
    block_size: int, plain: bool = False,
) -> Callable:
    """Returns ``step(params, pool, tables [1, M] int32, tokens [1, P],
    n_real) -> (last_logits [V], captures)``: the whole (right-padded) prompt
    in one call straight into the slot's pool blocks via the flash-prefill
    kernel.

    ``q_start=0`` pins query 0 at position 0, so attention covers only the
    causal lower triangle.  Pad tokens past ``n_real`` write K/V beyond the
    slot's ``kv_len`` (or into the null block), where every later read masks
    them and the first decode write overwrites them.
    """
    _check_servable(cfg)

    @torch.inference_mode()
    def step(params, pool, tables, tokens, n_real):
        pos = torch.zeros((1,), dtype=torch.int32, device=tokens.device)
        hidden, caps = _pool_forward(cfg, params, pool, tables, tokens, pos,
                                     block_size=block_size, plain=plain,
                                     collector=collector, prefill=True,
                                     q_start=0)
        last = hidden[:, n_real - 1:n_real]
        return L.logits_fn(params, cfg, last)[0, 0], caps

    return step


# ---------------------------------------------------------------------------
# Dense-cache steps: the recurrent families' segments, the gathered path
# ---------------------------------------------------------------------------


def make_seg_prefill(cfg: ModelConfig, collector: Collector = NULL_COLLECTOR, *,
                     plain: bool = False) -> Callable:
    """Returns ``seg(params, cache, tokens [1, W], pos) -> (last_logits [V],
    captures)``: one exact-length prompt segment integrated into the dense
    one-row cache (``lm.init_cache``) at offset ``pos``, in place, for the
    recurrent-state families, whose prefill must visit every real position.

    The server splits a prompt into its descending binary decomposition (13
    -> 8 + 4 + 1) and runs one segment a power of two, carrying the cache
    between calls, as the JAX package does to bound its compile set; the
    widths also pick the WKV form (32 and more: the clamped chunk form).
    The last segment ends at the prompt's end, so its logits are the first
    token's.
    """
    _check_servable(cfg)

    @torch.inference_mode()
    def seg(params, cache, tokens, pos):
        hidden, aux = lm.forward(cfg, params, tokens, cache=cache, cache_pos=pos,
                                 plain=plain, collector=collector)
        return L.logits_fn(params, cfg, hidden[:, -1:])[0, 0], aux.get("captures", {})

    return seg


def _row(tree: dict, s: int) -> dict:
    """Batch row ``s`` of every ``[n, B, ...]`` leaf, as a ``[n, 1, ...]``
    view (writes go through to ``tree``)."""
    return lm.tree_map(lambda a: a[:, s:s + 1], tree)


def make_slot_decode_step(cfg: ModelConfig,
                          collector: Collector = NULL_COLLECTOR) -> Callable:
    """Returns ``step(params, dense, tokens [S], pos [S], slots=None) ->
    (logits [S, V], captures)``: the gathered path's decode over the dense
    view ``dense`` (``PagedKVCache.gather``), updated in place.

    Each slot of ``slots`` (default: all) runs its own B=1 ``lm.forward``
    at its own position, as JAX's ``jax.vmap`` of a B=1 forward does, so a
    probe's reductions see one slot at a time; each capture leaf is stacked
    on a leading slot axis of ``S`` (a slot left out gets zeros, and its
    logits row is zero).  Positions are read back to the host: the dense
    forward writes at an int offset.
    """
    _check_servable(cfg)

    @torch.inference_mode()
    def step(params, dense, tokens, pos, slots=None):
        S = tokens.shape[0]
        slots = list(range(S)) if slots is None else list(slots)
        positions = pos.tolist()
        rows: dict[int, tuple] = {}
        for s in slots:
            hidden, aux = lm.forward(cfg, params, tokens[s:s + 1, None],
                                     cache=_row(dense, s),
                                     cache_pos=positions[s], collector=collector)
            rows[s] = (L.logits_fn(params, cfg, hidden)[0, 0],
                       aux.get("captures", {}))
        first = next(iter(rows.values()))
        logits = torch.stack([rows[s][0] if s in rows else torch.zeros_like(first[0])
                              for s in range(S)])
        caps = first[1]
        if caps:
            caps = lm.tree_map(
                lambda *leaves: torch.stack(leaves),
                *[rows[s][1] if s in rows else lm.tree_map(torch.zeros_like, caps)
                  for s in range(S)])
        return logits, caps

    return step


def make_slot_prefill(cfg: ModelConfig,
                      collector: Collector = NULL_COLLECTOR) -> Callable:
    """Returns ``prefill(params, tokens [1, P], n_real, cache_len) ->
    (filled_cache, last_logits [V], captures)``: a fresh dense one-row cache
    of ``cache_len`` positions (a block multiple) filled by one forward from
    position 0; the logits are position ``n_real - 1``'s.  An
    attention-only family may pass right-padded tokens (causal masking keeps
    the real positions blind to the pads, whose K/V lie past ``kv_len``); a
    recurrent one passes the exact prompt."""
    _check_servable(cfg)

    @torch.inference_mode()
    def prefill(params, tokens, n_real, cache_len):
        cache = lm.init_cache(cfg, 1, cache_len, device=tokens.device)
        hidden, aux = lm.forward(cfg, params, tokens, cache=cache, cache_pos=0,
                                 collector=collector)
        last = hidden[:, n_real - 1:n_real]
        return cache, L.logits_fn(params, cfg, last)[0, 0], aux.get("captures", {})

    return prefill
