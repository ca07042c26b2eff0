"""MegaServe front-end: ``submit() / step() / drain()`` over the paged engine.

Counterpart of ``repro.serve.server``.  One ``step()`` is one scheduler tick:
admit + prefill newly-arrived requests (or start streaming them chunk by
chunk), grow block tables (preempting if the pool is dry), run one fused
decode step, or one speculative verify step, for every slot, evict finished
slots so their space refills next tick.  Every prefill, chunk and decode is
bracketed by a MegaScan ``Tracer`` scope, and the speculative phases record
``draft``, ``verify`` and ``accept`` events, so serving timelines are the
same ``TraceEvent``s as in the JAX package.

With a metrics registry (``registry=``, or a ``Session``'s through
:meth:`MegaServe.from_session`) every tick publishes the JAX package's serve
series under the same names: queue-wait, prefill, chunk, TTFT, decode-step
and verify-step histograms, token, preemption and speculation counters,
queue-depth, active-slot, KV-occupancy and acceptance gauges.  All of it is
host bookkeeping around values a tick reads back anyway.

Engine paths, chosen as JAX chooses them (``ServeConfig``'s docstring):

* decode: ``"paged"`` runs K3 on the card (its plain version on the CPU)
  for every family; ``"gathered"``, the oracle, gathers the pool into a
  dense view, runs one B=1 forward a slot and scatters each written block
  back; ``"auto"`` takes the gathered path under a MegaScope collector,
  whose captures it stacks over the slot axis, and for MLA, whose latent
  cache the paged kernels cannot walk;
* prefill: an attention-only family's right-padded prompt goes through the
  flash-prefill kernel (K4) straight into its blocks, or (``"dense"``, and
  always on the gathered path) through one forward over a dense one-row
  cache then scattered; a recurrent family's prompt goes through the pow2
  segment driver, or one exact forward under a collector;
* chunked prefill and speculative verification run K4 at Q = chunk and Q =
  ``spec_k + 1`` over each slot's cached prefix.

Serving is greedy: every token is the argmax, as the JAX package's keyless
``sample`` makes it (ROADMAP R7).  ``StaticRunner`` is the lockstep
baseline.  For MegaRoute (``repro_torch.serve.router``) a server can run
prefill-only and hand a prefilled slot to another server
(``export_request`` / ``adopt_request``).  ``precompile()`` warms every
bucketed step variant before the first request, through the persistent
compile cache when one is attached (``compile_cache=``).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compile_cache import mesh_descriptor
from repro_torch.core.simkit.workload import (
    bursty_requests,
    diurnal_requests,
    poisson_requests,
)
from repro_torch.core.tracing.tracer import Tracer
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.hooks import NULL_COLLECTOR, Collector
from repro_torch.serve.engine import (
    make_chunk_prefill_step,
    make_decode_step,
    make_flash_prefill_step,
    make_paged_decode_step,
    make_prefill_step,
    make_seg_prefill,
    make_slot_decode_step,
    make_slot_prefill,
    make_spec_verify_step,
)
from repro_torch.serve.paged_cache import (
    PagedKVCache,
    PoolSpec,
    blocks_for,
    pow2_bucket,
    pow2_segments,
)
from repro_torch.serve.request import Request, RequestStatus, aggregate_metrics
from repro_torch.serve.sampler import greedy_verify, sample
from repro_torch.serve.scheduler import Scheduler, ServeConfig
from repro_torch.serve.spec import Drafter, NGramDrafter


_PRECOMPILE_PATHS = ("decode", "prefill", "chunk", "verify")


def _launch_counters() -> list[dict]:
    """Every kernel wrapper's ``launches`` dict."""
    from repro_torch.kernels.flash_attention import ops as k2
    from repro_torch.kernels.paged_attention import ops as k34
    from repro_torch.kernels.rglru import ops as k6
    from repro_torch.kernels.rmsnorm import ops as k1
    from repro_torch.kernels.wkv6 import ops as k5

    return [k1.launches, k2.launches, k34.launches, k5.launches, k6.launches]


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


@dataclass
class StreamItem:
    """One generated token of one request, with its probe captures.

    The admission item's captures come from the B=1 prefill over the whole
    prompt (leaves keep their batch=1 and time axes); later items are a
    slot's slice of the gathered decode's captures, or, on the paged path,
    the batched step's whole captures, as in the JAX package.
    """
    step: int
    token: int
    captures: dict = field(default_factory=dict)


class MegaServe:
    """Continuous-batching serving front-end: ``submit() / step() / drain()``.

    ``params`` are the model's float32 parameters (``lm.init`` or
    ``weights.from_jax_params``); the server keeps one copy on ``device``
    with every matrix and bias cast to the compute dtype.  ``device``
    defaults to the card and raises where there is none; ``"cpu"`` runs the
    plain attention versions.  ``collector`` is a MegaScope collector whose
    captures attach to each token's ``StreamItem``; ``drafter`` proposes
    speculative drafts (the n-gram drafter by default under
    ``spec_decode``); ``clock`` injects a time source for deterministic
    tests.  ``wrap_step`` decorates every engine step (the
    ``ModulePlugin.wrap_step`` attach point); ``registry`` receives the serve
    series, named ``<metrics_prefix><name>`` (``serve.`` by default; the
    router runs replica ``i`` under ``serve.r{i}.``).  A ``prefill_only``
    server admits and prefills, emitting each request's first token, and
    never drafts or decodes: the router moves its prefilled slots to a
    decode server (``export_request`` / ``adopt_request``).  ``params``
    already on ``device`` in the compute dtype are used as they are, not
    copied, so servers given one cast tree share its weights.  The KV pool
    is updated in place every step.  Greedy streams are token-identical
    across the engine paths: paged and gathered, flash, dense and chunked
    prefill, speculative and plain, and through preemption round trips.
    ``compile_cache`` (a ``repro_torch.core.compile_cache.CompileCache``)
    is where :meth:`precompile` keeps its warm-up records and the kernels'
    builds.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        serve_cfg: ServeConfig = ServeConfig(),
        *,
        device: str = "cuda",
        collector: Collector = NULL_COLLECTOR,
        tracer: Tracer | None = None,
        clock: Callable[[], float] | None = None,
        drafter: Drafter | None = None,
        wrap_step: Callable[[Callable], Callable] | None = None,
        registry=None,
        metrics_prefix: str = "serve.",
        prefill_only: bool = False,
        compile_cache=None,
    ):
        self.compile_cache = compile_cache
        self.collector = collector
        self._capture = collector is not NULL_COLLECTOR
        # decode path: the paged kernels need K/V leaves with a head axis
        # (MLA's latent cache has none); speculative verification exists on
        # the paged path only, so spec_decode overrides a collector's
        # gathered bias
        paged_ok = not cfg.use_mla
        path = serve_cfg.decode_path
        if path == "auto":
            if serve_cfg.spec_decode:
                path = "paged"
            else:
                path = "paged" if paged_ok and not self._capture else "gathered"
        elif path not in ("paged", "gathered"):
            raise ValueError(f"unknown decode_path {serve_cfg.decode_path!r}")
        if path == "paged" and not paged_ok:
            raise ValueError(f"{cfg.name}: decode_path='paged' unsupported (MLA)")
        if serve_cfg.spec_decode and path != "paged":
            raise ValueError(
                "spec_decode requires the paged decode path "
                f"(got decode_path={serve_cfg.decode_path!r})")
        # right-padded prompts, the flash prefill, chunks and speculation
        # need every cache leaf paged; a recurrent state integrates every
        # position, so it prefills exactly (pow2 segments, or one forward
        # under a collector, whose captures must cover the whole prompt)
        flags = lm.tree_leaves(lm.paged_flags(cfg))
        self._pad_prefill = bool(flags) and all(flags)
        self._seg_ok = not self._pad_prefill and not self._capture
        if serve_cfg.spec_decode:
            if not self._pad_prefill:
                raise ValueError(
                    f"{cfg.name}: spec_decode needs an attention-only KV "
                    "cache (recurrent slot-state cannot roll back rejected "
                    "drafts)")
            if serve_cfg.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {serve_cfg.spec_k}")
        flash_ok = path == "paged" and self._pad_prefill
        ppath = serve_cfg.prefill_path
        if ppath == "auto":
            # the port's kernels are real wherever its tensors are on the
            # card, and their plain versions stand in on the CPU, so "auto"
            # takes flash wherever it is legal
            ppath = "flash" if flash_ok else "dense"
        elif ppath not in ("flash", "dense"):
            raise ValueError(f"unknown prefill_path {serve_cfg.prefill_path!r}")
        if ppath == "flash" and not flash_ok:
            raise ValueError(
                f"{cfg.name}: prefill_path='flash' needs the paged decode "
                "path and an attention-only KV cache (got "
                f"decode_path={path!r})")
        if serve_cfg.chunked_prefill and not flash_ok:
            raise ValueError(
                f"{cfg.name}: chunked_prefill needs the paged decode path "
                "and an attention-only KV cache (recurrent slot-state must "
                "integrate every position in one pass); got "
                f"decode_path={path!r}")
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.decode_path, self.prefill_path = path, ppath
        self.device = resolve_device(device)
        self.params = lm.cast_params(
            params, getattr(torch, cfg.compute_dtype), self.device)
        self.sched = Scheduler(serve_cfg)
        self.tracer = tracer or Tracer(rank=0, enabled=True)
        self.registry = registry
        self._mpfx = metrics_prefix
        self.prefill_only = prefill_only
        self.streams: dict[int, list[StreamItem]] = {}
        self.step_idx = 0
        self._next_rid = 0
        # offset-based clock: t=0 at construction (or last reset())
        self._raw_clock = clock or time.perf_counter
        self._base = self._raw_clock()
        self._clock = lambda: self._raw_clock() - self._base

        self.kv = PagedKVCache(
            cfg,
            PoolSpec(
                num_slots=serve_cfg.num_slots,
                num_blocks=serve_cfg.num_blocks,
                block_size=serve_cfg.block_size,
                max_blocks=serve_cfg.max_blocks_per_slot,
            ),
            self.device,
        )
        self.pool = self.kv.pool
        bs = serve_cfg.block_size
        wrap = wrap_step or (lambda f: f)
        if path == "paged":
            paged_step = make_paged_decode_step(cfg, collector, block_size=bs)

            def decode_fn(params, pool, tables, tokens, pos, active):
                return paged_step(params, pool, tables, tokens, pos)
        else:
            slot_step = make_slot_decode_step(cfg, collector)

            def decode_fn(params, pool, tables, tokens, pos, active):
                dense = self.kv.gather(pool, tables)
                logits, caps = slot_step(params, dense, tokens, pos, active)
                self.kv.scatter_decode(pool, dense, tables, pos)
                return logits, caps
        self._decode = wrap(decode_fn)

        self._spec_step = None
        self.drafter = drafter
        if serve_cfg.spec_decode:
            if self.drafter is None:
                self.drafter = NGramDrafter(max_ngram=serve_cfg.spec_ngram_max,
                                            min_ngram=serve_cfg.spec_ngram_min)
            self._spec_step = wrap(make_spec_verify_step(cfg, collector,
                                                         block_size=bs))
        # one-shot prefill: ``(params, pool, phys [1, n_blk], tokens [1, P],
        # n_real, slot) -> (logits, captures)``; the padded block list is the
        # slot's table row, where the flash kernel writes K/V directly
        if self._seg_ok:
            self._seg = wrap(make_seg_prefill(cfg, collector))
        elif ppath == "flash":
            flash = make_flash_prefill_step(cfg, collector, block_size=bs)

            def prefill_fn(params, pool, phys, tokens, n_real, slot):
                return flash(params, pool, phys, tokens, n_real)

            self._prefill = wrap(prefill_fn)
        else:
            slot_prefill = make_slot_prefill(cfg, collector)

            def prefill_fn(params, pool, phys, tokens, n_real, slot):
                filled, logits, caps = slot_prefill(
                    params, tokens, n_real, phys.shape[1] * bs)
                self.kv.scatter_prefill(pool, filled, slot, phys[0])
                return logits, caps

            self._prefill = wrap(prefill_fn)
        # chunked prefill: prompts longer than chunk_len stream block-aligned
        # chunks through K4, one a tick, decode ticks of other slots between
        self._chunking: dict[int, dict] = {}
        self._chunk_step = None
        if serve_cfg.chunked_prefill:
            self._chunk_step = wrap(make_chunk_prefill_step(cfg, collector,
                                                            block_size=bs))

    @classmethod
    def from_session(cls, session, params: Any, serve_cfg: ServeConfig, **kw):
        """A server wired to a ``repro_torch.app.Session``: the session's
        MegaScan tracer, MegaScope collector, metrics registry, device and
        compile cache become this server's, and its steps run through the
        plugins' ``wrap_step`` chain."""
        kw.setdefault("registry", session.metrics_registry)
        kw.setdefault("device", session.device)
        kw.setdefault("compile_cache", getattr(session, "compile_cache", None))
        return cls(session.model_cfg, params, serve_cfg,
                   collector=session.collector, tracer=session.tracer,
                   wrap_step=session.wrap_step, **kw)

    # -------------------------------------------------------------- intake
    def submit(
        self,
        prompt: list[int],
        max_new: int,
        *,
        arrival: float | None = None,
        eos_id: int | None = None,
        rid: int | None = None,
    ) -> int:
        """Queue a prompt; returns its rid."""
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        else:
            self._next_rid = max(self._next_rid, rid + 1)
        req = Request(
            rid=rid, prompt=list(prompt), max_new=max_new,
            arrival=self._clock() if arrival is None else arrival,
            eos_id=eos_id,
            draft_len=self.serve_cfg.spec_k if self._spec_step else 0,
        )
        self.sched.submit(req)
        self.streams[rid] = []
        return rid

    # ------------------------------------------------------------ helpers
    def _prefill_blocks(self, n_tokens: int) -> int:
        """Block count a prefill of ``n_tokens`` covers: the power-of-two
        bucket, capped at the table width (the JAX package's compile-cache
        bucketing, kept so both sides run the same padded shapes), except
        for a state family under a live collector, whose one exact forward
        keeps the exact count."""
        n_blk = blocks_for(n_tokens, self.serve_cfg.block_size)
        if not self._pad_prefill and not self._seg_ok:
            return n_blk
        return min(pow2_bucket(n_blk), self.serve_cfg.max_blocks_per_slot)

    def _seg_prefill(self, tokens: list[int], slot: int,
                     phys: list[int]) -> tuple[torch.Tensor, dict]:
        """The recurrent families' prefill (JAX ``_make_seg_driver``): the
        prompt's descending pow2 segments, exact (no token invented), each
        through the segment step over one dense one-row cache of the
        bucketed length, then that cache scattered into the slot's pool
        blocks (``phys`` padded to the bucket width with the null block) and
        state row.  Returns the last position's logits and captures."""
        n_blk = self._prefill_blocks(len(tokens))
        cache = lm.init_cache(self.cfg, 1, n_blk * self.serve_cfg.block_size,
                              device=self.device)
        toks = self._tensor([tokens], torch.int64)
        off = 0
        for w in pow2_segments(len(tokens)):
            logits, caps = self._seg(self.params, cache, toks[:, off:off + w], off)
            off += w
        self.kv.scatter_prefill(
            self.pool, cache, slot,
            self._tensor(phys + [0] * (n_blk - len(phys)), torch.int32))
        return logits, caps

    def _tensor(self, values, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype).to(self.device)

    def _live_tables(self, active: list[int]) -> torch.Tensor:
        """Block tables for the decode/verify step.  On the paged path they
        are sliced to the live-block high-water mark (next power of two): the
        kernel's sweep then costs O(max live kv_len); the gathered path
        gathers the full tables, as JAX's does."""
        if self.decode_path != "paged":
            return self._tensor(self.sched.tables, torch.int32)
        live = max((len(self.sched.blocks[s]) for s in active), default=1)
        hb = min(pow2_bucket(live), self.serve_cfg.max_blocks_per_slot)
        return self._tensor(np.ascontiguousarray(self.sched.tables[:, :hb]),
                            torch.int32)

    def _m(self, name: str) -> str:
        return self._mpfx + name

    # --------------------------------------------------------------- step
    def step(self) -> dict:
        """One scheduler tick; returns what happened for observability."""
        now = self._clock()
        admitted, tokens_out = [], 0
        chunk_min = (self.serve_cfg.resolved_chunk_len
                     if self._chunk_step is not None else None)

        for adm in self.sched.admit(now):
            if self.registry is not None and not adm.is_recompute:
                wait = self.sched.requests[adm.rid].queue_wait
                if wait is not None:
                    self.registry.histogram(
                        self._m("queue_wait_s")).observe(wait)
            n_real = len(adm.tokens)
            if chunk_min is not None and n_real > chunk_min:
                # a long prompt streams chunk by chunk (its first chunk runs
                # below), decode ticks of other slots between its chunks
                self._chunking[adm.slot] = {
                    "rid": adm.rid, "toks": list(adm.tokens),
                    "written": 0, "t0": now,
                }
                admitted.append(adm.rid)
                continue
            t_pre = self._clock()
            with self.tracer.scope(
                "prefill", kind="compute", rid=adm.rid, slot=adm.slot,
                tokens=n_real, recompute=adm.is_recompute,
                step=self.step_idx,
            ):
                if self._seg_ok:
                    logits, caps = self._seg_prefill(
                        list(adm.tokens), adm.slot, list(adm.phys))
                else:
                    # an attention-only family right-pads the tokens to the
                    # bucketed length (their K/V land past kv_len or in the
                    # null block, which every read masks), a state family
                    # under a collector keeps them exact; the block list
                    # pads to the bucket width with null-block entries
                    n_blk = self._prefill_blocks(n_real)
                    toks = list(adm.tokens)
                    if self._pad_prefill:
                        toks += [0] * (n_blk * self.serve_cfg.block_size - n_real)
                    phys = list(adm.phys) + [0] * (n_blk - len(adm.phys))
                    logits, caps = self._prefill(
                        self.params, self.pool,
                        self._tensor([phys], torch.int32),
                        self._tensor([toks], torch.int64), n_real, adm.slot,
                    )
                tok = int(torch.argmax(logits))  # reads back: ends device work
            now = self._clock()
            self._emit(adm.slot, tok, caps, slot_axis=False)
            self.sched.record_token(adm.slot, tok, now)
            if self.registry is not None:
                self.registry.histogram(self._m("prefill_s")).observe(now - t_pre)
                if not adm.is_recompute:  # recomputes kept their first TTFT
                    ttft = self.sched.requests[adm.rid].ttft
                    if ttft is not None:
                        self.registry.histogram(self._m("ttft_s")).observe(ttft)
            admitted.append(adm.rid)
            tokens_out += 1

        # one chunk per chunking slot per tick; a completed last chunk
        # emits that request's first token
        if self._chunking:
            tokens_out += self._chunk_tick()
            now = self._clock()

        # a prefill token can complete a request (max_new=1, or eos): evict
        # before decode or the slot runs one step past its budget
        finished = self.sched.evict_finished(now)

        # mid-chunking slots hold blocks but cannot decode yet: they are
        # left out of drafting and decoding (their ride along the batched
        # step writes at pos, which the first real decode write overwrites);
        # a prefill-only server never decodes (its slots wait for export)
        preempted: list[int] = []
        active = self.sched.active_slots()
        if not self.prefill_only:
            runnable = [s for s in active if s not in self._chunking]
            # speculative drafts come before capacity planning: a slot about
            # to verify k drafts needs 1 + k write positions
            drafts: dict[int, list[int]] = {}
            if self._spec_step is not None and runnable:
                drafts = self._collect_drafts()
            preempted = self.sched.ensure_capacity(
                {s: 1 + len(d) for s, d in drafts.items()} if drafts else None)
            active = self.sched.active_slots()
            runnable = [s for s in active if s not in self._chunking]
            drafts = {s: d for s, d in drafts.items() if s in set(runnable)}
            if runnable:
                if drafts:
                    tokens_out += self._spec_tick(runnable, drafts)
                else:
                    tokens_out += self._decode_tick(runnable)
                now = self._clock()

        finished += self.sched.evict_finished(now)
        if admitted or active:
            self.step_idx += 1  # idle ticks don't count as engine steps
        # preempted alone still publishes: ensure_capacity can evict every
        # slot, and that count must not vanish
        if self.registry is not None and (admitted or active or preempted):
            self._publish_tick(active, preempted, tokens_out)
        return {
            "admitted": admitted,
            "preempted": preempted,
            "finished": finished,
            "active": len(active),
            "tokens": tokens_out,
        }

    def _chunk_tick(self) -> int:
        """Advance every mid-chunking slot by one prompt chunk; returns the
        number of first tokens emitted (chunking runs that finished).  A slot
        whose rid no longer matches was preempted mid-chunking: its entry is
        dropped and the re-admission restarts chunking from scratch, so
        greedy streams stay token-identical under preemption."""
        scfg = self.serve_cfg
        C, bs = scfg.resolved_chunk_len, scfg.block_size
        out = 0
        for slot in sorted(self._chunking):
            st = self._chunking[slot]
            if self.sched.slots[slot] != st["rid"]:
                del self._chunking[slot]
                continue
            toks, w = st["toks"], st["written"]
            n_real = len(toks)
            chunk = toks[w:w + C]
            final = w + C >= n_real
            n_last = (n_real - 1 - w) if final else (len(chunk) - 1)
            chunk = chunk + [0] * (C - len(chunk))
            # table width: the pow2 bucket over the blocks this chunk can
            # touch, as the JAX package buckets it
            width = min(pow2_bucket(blocks_for(w + C, bs)),
                        scfg.max_blocks_per_slot)
            tables = self._tensor(
                np.ascontiguousarray(self.sched.tables[slot:slot + 1, :width]),
                torch.int32)
            t0 = self._clock()
            with self.tracer.scope(
                "prefill_chunk", kind="compute", rid=st["rid"], slot=slot,
                offset=w, tokens=min(C, n_real - w), step=self.step_idx,
            ):
                logits, caps = self._chunk_step(
                    self.params, self.pool, tables,
                    self._tensor([chunk], torch.int64),
                    self._tensor([w], torch.int32), n_last,
                )
                tok = int(torch.argmax(logits))  # reads back: ends device work
            now = self._clock()
            if self.registry is not None:
                self.registry.histogram(self._m("chunk_s")).observe(now - t0)
            st["written"] = w + C
            if not final:
                continue
            del self._chunking[slot]
            self._emit(slot, tok, caps, slot_axis=False)
            self.sched.record_token(slot, tok, now)
            req = self.sched.requests[st["rid"]]
            if self.registry is not None:
                self.registry.histogram(
                    self._m("prefill_s")).observe(now - st["t0"])
                if req.n_preemptions == 0 and req.ttft is not None:
                    self.registry.histogram(self._m("ttft_s")).observe(req.ttft)
            out += 1
        return out

    def _publish_tick(
        self, active: list[int], preempted: list[int], tokens_out: int
    ) -> None:
        """Per-tick serve series into the registry (host bookkeeping only)."""
        reg, alloc = self.registry, self.sched.allocator
        reg.counter(self._m("tokens")).inc(tokens_out)
        if preempted:
            reg.counter(self._m("preemptions")).inc(len(preempted))
        reg.gauge(self._m("queue_depth")).set(len(self.sched.waiting))
        reg.gauge(self._m("active_slots")).set(len(active))
        used = alloc.num_blocks - alloc.reserved - alloc.num_free
        reg.gauge(self._m("kv_occupancy")).set(
            used / max(self.serve_cfg.usable_blocks, 1)
        )

    def _decode_tick(self, active: list[int]) -> int:
        """One plain fused decode step (1 token a slot).  On the paged path
        every slot rides the batch, inactive ones at position 0 of the null
        block, as in the JAX package; the gathered path runs the active
        slots' B=1 forwards."""
        toks = self._tensor(self.sched.last_tok, torch.int64)
        pos = self._tensor(self.sched.pos, torch.int32)
        tables = self._live_tables(active)
        t_dec = self._clock()
        with self.tracer.scope(
            "decode", kind="compute", step=self.step_idx,
            active=len(active), tokens=len(active),
        ):
            logits, caps = self._decode(self.params, self.pool, tables, toks,
                                        pos, active)
            next_tok = torch.argmax(logits, -1).tolist()
        now = self._clock()
        if self.registry is not None:
            self.registry.histogram(self._m("decode_step_s")).observe(now - t_dec)
        for s in active:
            self.sched.advance(s)
            self._emit(s, next_tok[s], caps,
                       slot_axis=(self.decode_path == "gathered"))
            self.sched.record_token(s, next_tok[s], now)
        return len(active)

    # --------------------------------------------------------- speculation
    def _collect_drafts(self) -> dict[int, list[int]]:
        """Ask the drafter for proposals, one per active slot.

        Each request's draft budget is its adapted ``draft_len`` capped so
        the verify writes stay inside the slot's table reach and the
        request's remaining token budget.  Requests whose budget has adapted
        to 0 re-probe with a 1-token draft every ``spec_retry`` steps, times
        their backoff."""
        t0 = self._clock()
        drafts: dict[int, list[int]] = {}
        proposed = 0
        for s in self.sched.active_slots():
            if s in self._chunking:   # no committed tokens to draft from yet
                continue
            req = self.sched.requests[self.sched.slots[s]]
            if req.draft_len == 0:
                # exponential re-probe backoff: a request that keeps failing
                # its probes is probed less and less often
                req.spec_idle += 1
                if req.spec_idle >= self.serve_cfg.spec_retry * req.spec_backoff:
                    req.spec_idle = 0
                    req.draft_len = 1
                continue
            k = min(
                req.draft_len,
                self.serve_cfg.spec_k,
                req.remaining - 1,
                self.serve_cfg.max_len - self.sched.pos[s] - 1,
            )
            if k <= 0:
                continue
            # clamp: a proposal longer than k would overflow the verify row
            # and the slot's grown table reach
            d = list(self.drafter.propose(req.prompt + req.generated, k))[:k]
            if d:
                drafts[s] = d
                proposed += len(d)
        self.tracer.record(
            "draft", t0, self._clock() - t0, kind="host",
            step=self.step_idx, proposed=proposed, slots=len(drafts),
        )
        return drafts

    def _spec_tick(self, active: list[int], drafts: dict[int, list[int]]) -> int:
        """One batched draft-verification step.

        Every slot rides the same ``Q = spec_k + 1``-token forward: row 0 is
        its last committed token, rows 1..k its draft, the rest padding
        (causally invisible to the rows that matter).  Greedy acceptance
        (``sampler.greedy_verify``) commits the agreeing prefix plus one
        correction or bonus token a slot, between 1 and ``k + 1`` tokens;
        then the block tables are rewound past the committed high-water mark
        (``Scheduler.trim_blocks``)."""
        scfg = self.serve_cfg
        Q = scfg.spec_k + 1
        toks = np.zeros((scfg.num_slots, Q), np.int64)
        for s in active:
            row = [self.sched.last_tok[s]] + drafts.get(s, [])
            toks[s, :len(row)] = row
        pos = self._tensor(self.sched.pos, torch.int32)
        tables = self._live_tables(active)
        v0 = self._clock()
        logits, caps = self._spec_step(self.params, self.pool, tables,
                                       self._tensor(toks, torch.int64), pos)
        greedy = torch.argmax(logits, -1).cpu().numpy()
        now = self._clock()
        v_dur = now - v0
        t0 = now
        emitted_total = accepted_total = 0
        for s in active:
            d = drafts.get(s, [])
            n_acc, emitted = greedy_verify(greedy[s], d)
            req = self.sched.requests[self.sched.slots[s]]
            if d:
                req.spec_proposed += len(d)
                req.spec_accepted += n_acc
                accepted_total += n_acc
                # the verify forward costs the same whatever the draft
                # length (Q is padded), so any acceptance restores the full
                # budget; only consecutive zero-acceptance verifies shut
                # speculation off for the request, with backed-off re-probes
                if n_acc > 0:
                    req.draft_len = scfg.spec_k
                    req.spec_miss = 0
                    req.spec_backoff = 1
                else:
                    req.spec_miss += 1
                    if req.spec_miss >= 3:
                        req.draft_len = 0
                        req.spec_backoff = min(req.spec_backoff * 2, 16)
            n_commit = 0
            for t in emitted[:req.remaining]:
                n_commit += 1
                self._emit(s, int(t), caps, slot_axis=False)
                self.sched.record_token(s, int(t), now)
                if req.eos_id is not None and int(t) == req.eos_id:
                    break
            self.sched.advance(s, n_commit)
            emitted_total += n_commit
        self.sched.trim_blocks()
        # the verify event is recorded after acceptance so it can carry the
        # realized token count; ts/dur bracket exactly the verify forward
        drafted = sum(len(d) for d in drafts.values())
        self.tracer.record(
            "verify", v0, v_dur, kind="compute", step=self.step_idx,
            active=len(active), tokens=emitted_total, drafted=drafted,
        )
        self.tracer.record(
            "accept", t0, self._clock() - t0, kind="host",
            step=self.step_idx, accepted=accepted_total, emitted=emitted_total,
        )
        if self.registry is not None:
            reg = self.registry
            reg.histogram(self._m("verify_step_s")).observe(v_dur)
            if drafted:
                reg.counter(self._m("spec_proposed")).inc(drafted)
                reg.counter(self._m("spec_accepted")).inc(accepted_total)
                reg.gauge(self._m("spec_accept_rate")).set(
                    reg.counter(self._m("spec_accepted")).value
                    / reg.counter(self._m("spec_proposed")).value
                )
        return emitted_total

    def _emit(self, slot: int, tok: int, caps: Any, *, slot_axis: bool) -> None:
        rid = self.sched.slots[slot]
        captures = {}
        if self._capture and caps:
            # slot_axis only on the gathered path, where every capture leaf
            # is stacked over the slot axis, so slicing is exact; the
            # batched paged step's captures attach whole (a probe's
            # reductions there may span every slot)
            take = (lambda a: _host(a[slot])) if slot_axis else _host
            captures = lm.tree_map(take, caps)
        self.streams[rid].append(StreamItem(self.step_idx, tok, captures))

    # ---------------------------------------------------------- migration
    def exportable(self) -> list[int]:
        """Rids whose prefill has completed here and whose decode has not
        begun: on a prefill-only server these are ready for hand-off (a
        colocated server never exports; it decodes its own prefills).
        Chunking slots are not exportable."""
        if not self.prefill_only:
            return []
        out = []
        for s in self.sched.active_slots():
            if s in self._chunking:
                continue
            req = self.sched.requests[self.sched.slots[s]]
            if req.t_first_token is not None and not req.done:
                out.append(req.rid)
        return out

    def _sync(self) -> None:
        """Waits for the card, so a ``kv_export``/``kv_import`` scope times
        the copy itself (nothing else reads it back)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def export_request(self, rid: int) -> dict:
        """Pull a prefilled request out of this server: its KV blocks leave
        the pool as an ``export_slot`` bundle (padded to the pow2 block
        bucket with null-block entries), its slot and blocks are freed, and
        the ``Request`` object and its token stream ride the package, so
        timing fields and emitted tokens survive the move."""
        slot = next(
            (s for s, r in enumerate(self.sched.slots) if r == rid), None)
        if slot is None:
            raise ValueError(f"rid {rid} not active (cannot export)")
        req = self.sched.requests[rid]
        phys = list(self.sched.blocks[slot])
        pos = self.sched.pos[slot]
        last_tok = self.sched.last_tok[slot]
        width = min(
            pow2_bucket(max(len(phys), 1)), self.serve_cfg.max_blocks_per_slot)
        padded = phys + [0] * (width - len(phys))
        with self.tracer.scope(
            "kv_export", kind="comm", rid=rid, slot=slot, blocks=len(phys),
            step=self.step_idx,
        ):
            bundle = self.kv.export_slot(
                self.pool, self._tensor(padded, torch.int32), slot)
            self._sync()
        stream = self.streams.pop(rid)
        self.sched.release_request(rid)
        return {
            "req": req, "stream": stream, "bundle": bundle,
            "n_blocks": len(phys), "width": width,
            "pos": pos, "last_tok": last_tok,
        }

    def adopt_request(self, package: dict) -> bool:
        """Install an ``export_request`` package into this server: claim a
        slot and blocks, write the bundle's KV into them, and resume decode
        from the migrated cursor.  Returns False (package untouched) when no
        slot or blocks are free; the router retries next tick.  The import
        copies the blocks bit for bit, so the greedy continuation is the
        colocated engine's."""
        req = package["req"]
        got = self.sched.adopt(req, package["pos"], package["last_tok"])
        if got is None:
            return False
        slot, phys = got
        padded = phys + [0] * (package["width"] - len(phys))
        with self.tracer.scope(
            "kv_import", kind="comm", rid=req.rid, slot=slot,
            blocks=package["n_blocks"], step=self.step_idx,
        ):
            self.kv.import_slot(
                self.pool, package["bundle"], self._tensor(padded, torch.int32),
                slot)
            self._sync()
        self.streams[req.rid] = package["stream"]
        self._next_rid = max(self._next_rid, req.rid + 1)
        return True

    # --------------------------------------------------------- precompile
    def _width_ladder(self, hi: int) -> list[int]:
        """The pow2 bucket ladder 1, 2, 4, ... capped at ``hi``: exactly
        the static widths the tick paths can request."""
        ws, w = [], 1
        while True:
            ws.append(w)
            if w >= hi:
                return ws
            w = min(2 * w, hi)

    def _pool_snapshot(self) -> dict:
        """What a warm-up step can write: the null block of every paged
        leaf and every slot-state leaf."""
        return lm.tree_map(lambda p, paged: (p[:, 0] if paged else p).clone(),
                           self.pool, self.kv.paged)

    def _pool_restore(self, snap: dict) -> None:
        lm.tree_map(lambda p, paged, saved: (p[:, 0] if paged else p).copy_(saved),
                    self.pool, self.kv.paged, snap)

    def _warm(self, path: str, run: Callable[[], Any], parts: dict,
              out: dict) -> None:
        """One bucket (its cache key ``parts``): its record looked up in the
        compile cache (a hit loads the libraries it names first), its step
        run once on throwaway inputs, the record put on a miss."""
        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        cache, blob = self.compile_cache, None
        if cache is not None:
            key = cache.key(step=path, **parts)
            blob = cache.load(key)
            if blob is not None:
                for name in json.loads(blob)["libraries"]:
                    _build.load(name)
        before = [dict(c) for c in _launch_counters()]
        run()
        self._sync()
        if cache is not None and blob is None:
            used = sorted(n for c, b in zip(_launch_counters(), before)
                          for n in c if c[n] > b[n] and n in _build.SOURCES)
            cache.put(key, json.dumps({"libraries": used}).encode())
        out[path]["count"] += 1
        out[path]["ms"] += (time.perf_counter() - t0) * 1e3

    def precompile(self) -> dict:
        """Warm every bucketed step variant before serving.

        Each engine step runs at one of a ladder of pow2 static widths
        (decode and verify table widths, chunk widths, prefill prompt
        buckets, recurrent segment widths x cache buckets), and the first
        run of each pays the kernels' builds (``nvcc`` of its libraries,
        K1's Triton compile), the kernels' first launches, cuBLAS's handle
        and workspace and the allocator's segments inside the serving loop.
        This walks every ladder as the JAX package's ``precompile`` does,
        running each variant once on throwaway inputs whose K/V writes land
        in the null block; the null block, the slot states, the RNG, the
        scheduler, the streams and the kernels' launch counters are left as
        they were.  With a ``compile_cache`` attached it becomes the
        process's kernel build cache (``kernels._build.use_cache``, which
        also moves Triton's cache under it), and each variant keeps a record
        there of the libraries it launched, which a restarted process loads
        before the variant runs.

        Returns per-path counts and wall-clock milliseconds::

            {"decode": {"count", "ms"}, "prefill": {...}, "chunk": {...},
             "verify": {...}, "total": n[, "cache": CacheStats dict]}

        and publishes each path's ms as a ``precompile_ms.<path>`` gauge.
        """
        from repro_torch.kernels import _build

        out: dict[str, Any] = {p: {"count": 0, "ms": 0.0} for p in _PRECOMPILE_PATHS}
        scfg = self.serve_cfg
        n_slots, max_w, bs = scfg.num_slots, scfg.max_blocks_per_slot, scfg.block_size
        if self.compile_cache is not None:
            _build.use_cache(self.compile_cache)
        base = dict(model=self.cfg, serve=self.serve_cfg, mesh=mesh_descriptor(None),
                    device=self.device.type, capture=self._capture,
                    params=[f"{tuple(t.shape)}/{t.dtype}"
                            for t in lm.tree_leaves(self.params)])
        counters = _launch_counters()
        saved = [dict(c) for c in counters]
        rng = (torch.random.get_rng_state(),
               torch.cuda.get_rng_state(self.device)
               if self.device.type == "cuda" else None)
        snap = self._pool_snapshot()
        i32, i64 = torch.int32, torch.int64
        zeros = lambda *shape, dtype=i32: torch.zeros(  # noqa: E731
            shape, dtype=dtype, device=self.device)
        try:
            # ---- decode: one variant per live-table width bucket
            widths = (self._width_ladder(max_w)
                      if self.decode_path == "paged" else [max_w])
            toks, pos = zeros(n_slots, dtype=i64), zeros(n_slots)
            for w in widths:
                self._warm("decode", lambda w=w: self._decode(
                    self.params, self.pool, zeros(n_slots, w), toks, pos, [0]),
                    base | {"width": w}, out)
            # ---- speculative verify: same width ladder, Q = spec_k + 1 rows
            if self._spec_step is not None:
                vt = zeros(n_slots, scfg.spec_k + 1, dtype=i64)
                for w in widths:
                    self._warm("verify", lambda w=w: self._spec_step(
                        self.params, self.pool, zeros(n_slots, w), vt, pos),
                        base | {"width": w}, out)
            # ---- chunked prefill: the chunk-tick table widths reachable
            if self._chunk_step is not None:
                C = scfg.resolved_chunk_len
                cws = sorted({min(pow2_bucket(blocks_for(off + C, bs)), max_w)
                              for off in range(0, scfg.max_len, C)})
                for w in cws:
                    self._warm("chunk", lambda w=w: self._chunk_step(
                        self.params, self.pool, zeros(1, w),
                        zeros(1, C, dtype=i64), zeros(1), C - 1),
                        base | {"width": w}, out)
            # ---- prefill: the prompt block-bucket ladder (padded families)
            # or the pow2 segment-width x cache-bucket grid (recurrent ones)
            if self._pad_prefill:
                for n_blk in self._width_ladder(max_w):
                    self._warm("prefill", lambda n=n_blk: self._prefill(
                        self.params, self.pool, zeros(1, n),
                        zeros(1, n * bs, dtype=i64), n * bs, 0),
                        base | {"n_blk": n_blk, "prefill_impl": self.prefill_path}, out)
            elif self._seg_ok:
                for n_blk in self._width_ladder(max_w):
                    L = n_blk * bs
                    cache = lm.init_cache(self.cfg, 1, L, device=self.device)
                    for w in self._width_ladder(L):
                        self._warm("prefill", lambda w=w, c=cache: self._seg(
                            self.params, c, zeros(1, w, dtype=i64), 0),
                            base | {"seg_w": w, "cache_len": L}, out)
                    self._warm("prefill", lambda n=n_blk, c=cache: (
                        self.kv.scatter_prefill(self.pool, c, 0, zeros(n))),
                        base | {"fin_blk": n_blk}, out)
        finally:
            self._pool_restore(snap)
            for c, before in zip(counters, saved):
                c.update(before)
            torch.random.set_rng_state(rng[0])
            if rng[1] is not None:
                torch.cuda.set_rng_state(rng[1], self.device)

        out["total"] = sum(out[p]["count"] for p in _PRECOMPILE_PATHS)
        if self.compile_cache is not None:
            out["cache"] = self.compile_cache.stats.as_dict()
        if self.registry is not None:
            for p in _PRECOMPILE_PATHS:
                self.registry.gauge(
                    self._m(f"precompile_ms.{p}")).set(out[p]["ms"])
        return out

    # -------------------------------------------------------------- drain
    def drain(
        self,
        max_steps: int = 100_000,
        *,
        on_step: Callable[[list, dict], None] | None = None,
    ) -> dict[int, list[int]]:
        """Run until every submitted request finishes; returns token streams.

        ``max_steps`` bounds productive engine steps and (separately) idle
        ticks spent waiting for future arrivals.  ``on_step(events,
        report)`` observes each tick — the TraceEvents it emitted and the
        scheduler report — which is how Session plugins attach."""
        work = idle = 0
        while not self.sched.all_done:
            n_ev = len(self.tracer.events)
            out = self.step()
            if on_step is not None:
                on_step(self.tracer.events[n_ev:], out)
            if out["admitted"] or out["active"]:
                work += 1
                idle = 0
                if work > max_steps:
                    raise RuntimeError(f"drain: not done after {work} steps")
                continue
            idle += 1
            if idle > max_steps:
                raise RuntimeError(
                    f"drain: stalled waiting for arrival at "
                    f"t={self.sched.next_arrival()} (now={self._clock():.3f})"
                )
            nxt = self.sched.next_arrival()
            if nxt is not None:
                time.sleep(max(0.0, min(nxt - self._clock(), 1e-3)))
        return {rid: [it.token for it in s] for rid, s in self.streams.items()}

    # ------------------------------------------------------------ metrics
    def metrics(self) -> dict:
        """Fleet metrics: tokens/s, TTFT/latency percentiles, preemptions,
        engine steps, and (under speculation) draft acceptance."""
        reqs = list(self.sched.requests.values())
        out = {**aggregate_metrics(reqs, wall=self._clock()),
               "steps": self.step_idx}
        if self._spec_step is not None:
            proposed = sum(r.spec_proposed for r in reqs)
            accepted = sum(r.spec_accepted for r in reqs)
            out["spec_proposed"] = proposed
            out["spec_accepted"] = accepted
            out["spec_accept_rate"] = accepted / proposed if proposed else 0.0
        return out

    def trace_events(self):
        return self.tracer.events

    def reset(self) -> None:
        """Drop finished requests/streams/traces and restart the clock, so a
        warmed-up server times a fresh workload."""
        if not self.sched.all_done:
            raise RuntimeError("reset() with requests still in flight")
        self.sched.requests.clear()
        self.streams.clear()
        self.tracer.clear()
        self._chunking.clear()
        self.step_idx = 0
        self._base = self._raw_clock()


# ---------------------------------------------------------------------------
# Static-batch baseline (the lockstep path)
# ---------------------------------------------------------------------------


class StaticRunner:
    """Length-bucketed static batching: requests sharing one prompt length
    batch together in arrival order (the static steps take one prompt length
    and one shared position), the whole batch decodes in lockstep to the
    slowest member's budget, and a batch launches once its last member has
    arrived.  Greedy (``sample`` without a generator).  ``params`` are
    float32 parameters, cast once to the compute dtype on ``device`` as
    MegaServe casts them."""

    def __init__(self, cfg: ModelConfig, params: Any, *, device: str = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = lm.cast_params(
            params, getattr(torch, cfg.compute_dtype), self.device)
        self.prefill = make_prefill_step(cfg)
        self.decode = make_decode_step(cfg)

    def run(
        self,
        requests: list[tuple[list[int], int, float]],  # (prompt, max_new, arrival)
        *,
        batch_size: int,
        tracer: Tracer | None = None,
        clock: Callable[[], float] | None = None,
    ) -> tuple[dict[int, list[int]], dict]:
        """Returns (rid -> tokens, metrics); rids index ``requests``."""
        cfg, params = self.cfg, self.params
        tracer = tracer or Tracer(rank=0, enabled=True)
        t0 = time.perf_counter()
        clock = clock or (lambda: time.perf_counter() - t0)

        reqs = [Request(rid=i, prompt=list(p), max_new=m, arrival=a)
                for i, (p, m, a) in enumerate(requests)]
        buckets: dict[int, list[Request]] = {}
        for r in reqs:
            buckets.setdefault(r.prompt_len, []).append(r)

        outputs: dict[int, list[int]] = {}
        for P in sorted(buckets):
            group = buckets[P]
            for i in range(0, len(group), batch_size):
                members = group[i:i + batch_size]
                B = len(members)
                steps = max(r.max_new for r in members)
                launch = max(r.arrival for r in members)
                stalls = 0
                while clock() < launch:
                    before = clock()
                    time.sleep(min(launch - before, 1e-3))
                    # an injected clock may never advance: bail out instead
                    # of spinning forever (~10 s real)
                    stalls = stalls + 1 if clock() <= before else 0
                    if stalls > 10_000:
                        raise RuntimeError(
                            f"static: stalled waiting for batch launch at "
                            f"t={launch} (now={clock():.3f})")
                cache = lm.init_cache(cfg, B, P + steps, device=self.device)
                prompts = torch.tensor([r.prompt for r in members],
                                       dtype=torch.int64, device=self.device)
                with tracer.scope("prefill", kind="compute", tokens=B * P, batch=B):
                    logits, _ = self.prefill(params, {"tokens": prompts}, cache)
                    tok = sample(logits, temperature=0.0)
                    toks = tok.tolist()  # reads back: ends device work
                now = clock()
                for b, r in enumerate(members):
                    r.t_admitted = launch
                    r.t_first_token = now
                    r.generated.append(toks[b])
                    if len(r.generated) == r.max_new:
                        r.t_finished = now
                for s in range(steps - 1):
                    with tracer.scope("decode", kind="compute", step=s, active=B,
                                      tokens=B):
                        _, tok, _ = self.decode(params, cache, tok, P + s)
                        toks = tok.tolist()
                    now = clock()
                    for b, r in enumerate(members):
                        if len(r.generated) < r.max_new:
                            r.generated.append(toks[b])
                            if len(r.generated) == r.max_new:
                                r.t_finished = now
                for r in members:
                    if r.t_finished is None:
                        r.t_finished = now
                    r.status = RequestStatus.FINISHED
                    outputs[r.rid] = list(r.generated)

        metrics = aggregate_metrics(reqs, wall=clock())
        return outputs, metrics


def run_static(
    cfg: ModelConfig,
    params: Any,
    requests: list[tuple[list[int], int, float]],
    *,
    batch_size: int,
    device: str = "cuda",
    tracer: Tracer | None = None,
    clock: Callable[[], float] | None = None,
) -> tuple[dict[int, list[int]], dict]:
    """One-shot convenience wrapper over ``StaticRunner``."""
    return StaticRunner(cfg, params, device=device).run(
        requests, batch_size=batch_size, tracer=tracer, clock=clock)


def make_poisson_workload(
    cfg: ModelConfig,
    *,
    n: int,
    rate: float,
    prompt_lens: tuple[int, ...],
    max_new_range: tuple[int, int],
    num_slots: int,
    block_size: int = 16,
    num_blocks: int = 0,
    seed: int = 0,
    traffic: str = "poisson",
):
    """The CLI's workload: arrival specs (``traffic`` picks the process:
    ``poisson``, ``bursty`` MMPP or ``diurnal`` sinusoidal), random token
    prompts and a ``ServeConfig`` sized so the worst request fits one slot —
    ``num_blocks=0`` sizes the pool for zero preemption (every slot can hold
    its worst case at once, plus the null block).  The same seed gives the
    same specs and prompts as ``repro.serve.server.make_poisson_workload``.
    Returns (specs, prompts by rid, serve_cfg)."""
    gens = {
        "poisson": poisson_requests,
        "bursty": bursty_requests,
        "diurnal": diurnal_requests,
    }
    if traffic not in gens:
        raise ValueError(f"unknown traffic {traffic!r}; one of {sorted(gens)}")
    specs = gens[traffic](
        n, rate, prompt_lens=prompt_lens, max_new_range=max_new_range,
        seed=seed,
    )
    rng = np.random.default_rng(seed)
    prompts = {
        s.rid: rng.integers(2, cfg.vocab_size, size=s.prompt_len).tolist()
        for s in specs
    }
    worst = max(blocks_for(s.prompt_len + s.max_new, block_size) for s in specs)
    serve_cfg = ServeConfig(
        num_slots=num_slots, block_size=block_size,
        num_blocks=num_blocks or (num_slots * worst + 1),
        max_blocks_per_slot=worst,
    )
    return specs, prompts, serve_cfg
