"""MegaServe front-end: ``submit() / step() / drain()`` over the paged engine.

Counterpart of ``repro.serve.server``.  One ``step()`` is one scheduler tick:
admit + prefill newly-arrived requests, grow block tables (preempting if the
pool is dry), run one fused decode step for every slot, evict finished slots
so their space refills next tick.  Every prefill and decode is bracketed by a
MegaScan ``Tracer`` scope, so serving timelines are the same ``TraceEvent``s
as in the JAX package.

With a metrics registry (``registry=``, or a ``Session``'s through
:meth:`MegaServe.from_session`) every tick publishes the JAX package's serve
series under the same names: queue-wait, prefill, TTFT and decode-step
histograms, token and preemption counters, queue-depth, active-slot and
KV-occupancy gauges.  All of it is host bookkeeping around values a tick
reads back anyway.

This slice serves through the paged decode kernel and the flash-prefill
kernel on the card (their plain versions on the CPU).  The gathered and dense
paths, chunked prefill and MegaScope collectors in the engine steps
(ROADMAP queue 1, item 5), speculative decoding (item 10), the router and
slot migration (item 11) and precompilation (item 12b) arrive with later
slices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tracing.tracer import Tracer
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.engine import make_flash_prefill_step, make_paged_decode_step
from repro_torch.serve.paged_cache import PagedKVCache, PoolSpec, blocks_for, pow2_bucket
from repro_torch.serve.request import Request, aggregate_metrics
from repro_torch.serve.scheduler import Scheduler, ServeConfig


@dataclass
class StreamItem:
    """One generated token of one request."""
    step: int
    token: int


def _refuse(what: str, slice_: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported yet: it arrives with the {slice_} slice "
        f"(ROADMAP queue 1, {item})")


class MegaServe:
    """Continuous-batching serving front-end: ``submit() / step() / drain()``.

    ``params`` are the model's float32 parameters (``lm.init`` or
    ``weights.from_jax_params``); the server keeps one copy on ``device``
    with every matrix and bias cast to the compute dtype.  ``device``
    defaults to the card and raises where there is none; ``"cpu"`` runs the
    plain attention versions.  ``clock`` injects a time source for
    deterministic tests.  ``wrap_step`` decorates the prefill and decode
    steps (the ``ModulePlugin.wrap_step`` attach point); ``registry``
    receives the serve series, named ``serve.<name>``.  The KV
    pool is updated in place every step.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        serve_cfg: ServeConfig = ServeConfig(),
        *,
        device: str = "cuda",
        tracer: Tracer | None = None,
        clock: Callable[[], float] | None = None,
        wrap_step: Callable[[Callable], Callable] | None = None,
        registry=None,
    ):
        lm.require_paged(cfg)
        if serve_cfg.decode_path not in ("auto", "paged"):
            _refuse(f"decode_path={serve_cfg.decode_path!r}", "gathered-path",
                    "item 5")
        if serve_cfg.prefill_path not in ("auto", "flash"):
            _refuse(f"prefill_path={serve_cfg.prefill_path!r}", "dense-prefill",
                    "item 5")
        if serve_cfg.spec_decode:
            _refuse("spec_decode", "speculative-decoding", "item 10")
        if serve_cfg.chunked_prefill:
            _refuse("chunked_prefill", "chunked-prefill", "item 5")
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.device = resolve_device(device)
        self.params = lm.cast_params(
            params, getattr(torch, cfg.compute_dtype), self.device)
        # the paged kernel and flash prefill are what "auto" picks wherever
        # the kernels are real, which on the card they are
        self.decode_path, self.prefill_path = "paged", "flash"
        self.sched = Scheduler(serve_cfg)
        self.tracer = tracer or Tracer(rank=0, enabled=True)
        self.registry = registry
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
        self._decode = wrap(make_paged_decode_step(cfg, block_size=bs))
        self._prefill = wrap(make_flash_prefill_step(cfg, block_size=bs))

    @classmethod
    def from_session(cls, session, params: Any, serve_cfg: ServeConfig, **kw):
        """A server wired to a ``repro_torch.app.Session``: the session's
        MegaScan tracer, metrics registry and device become this server's,
        and its steps run through the plugins' ``wrap_step`` chain."""
        kw.setdefault("registry", session.metrics_registry)
        kw.setdefault("device", session.device)
        return cls(session.model_cfg, params, serve_cfg,
                   tracer=session.tracer, wrap_step=session.wrap_step, **kw)

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
        )
        self.sched.submit(req)
        self.streams[rid] = []
        return rid

    # ------------------------------------------------------------ helpers
    def _prefill_blocks(self, n_tokens: int) -> int:
        """Block count a prefill of ``n_tokens`` covers: the power-of-two
        bucket, capped at the table width (the JAX package's compile-cache
        bucketing, kept so both sides run the same padded shapes)."""
        n_blk = blocks_for(n_tokens, self.serve_cfg.block_size)
        return min(pow2_bucket(n_blk), self.serve_cfg.max_blocks_per_slot)

    def _tensor(self, values, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype).to(self.device)

    def _live_tables(self, active: list[int]) -> torch.Tensor:
        """Block tables sliced to the live-block high-water mark (next power
        of two): the decode kernel's sweep then costs O(max live kv_len)."""
        live = max((len(self.sched.blocks[s]) for s in active), default=1)
        hb = min(pow2_bucket(live), self.serve_cfg.max_blocks_per_slot)
        return self._tensor(np.ascontiguousarray(self.sched.tables[:, :hb]),
                            torch.int32)

    @staticmethod
    def _m(name: str) -> str:
        return "serve." + name

    # --------------------------------------------------------------- step
    def step(self) -> dict:
        """One scheduler tick; returns what happened for observability."""
        now = self._clock()
        admitted, tokens_out = [], 0

        for adm in self.sched.admit(now):
            if self.registry is not None and not adm.is_recompute:
                wait = self.sched.requests[adm.rid].queue_wait
                if wait is not None:
                    self.registry.histogram(
                        self._m("queue_wait_s")).observe(wait)
            n_real = len(adm.tokens)
            n_blk = self._prefill_blocks(n_real)
            # right-pad tokens to the bucketed length and the block list to
            # the bucket width with null-block entries (their K/V land in
            # block 0, which every read masks out)
            toks = list(adm.tokens) + [0] * (n_blk * self.serve_cfg.block_size - n_real)
            phys = list(adm.phys) + [0] * (n_blk - len(adm.phys))
            t_pre = self._clock()
            with self.tracer.scope(
                "prefill", kind="compute", rid=adm.rid, slot=adm.slot,
                tokens=n_real, recompute=adm.is_recompute,
                step=self.step_idx,
            ):
                logits = self._prefill(
                    self.params, self.pool,
                    self._tensor([phys], torch.int32),
                    self._tensor([toks], torch.int64), n_real,
                )
                tok = int(torch.argmax(logits))  # reads back: ends device work
            now = self._clock()
            self._emit(adm.slot, tok)
            self.sched.record_token(adm.slot, tok, now)
            if self.registry is not None:
                self.registry.histogram(self._m("prefill_s")).observe(now - t_pre)
                if not adm.is_recompute:  # recomputes kept their first TTFT
                    ttft = self.sched.requests[adm.rid].ttft
                    if ttft is not None:
                        self.registry.histogram(self._m("ttft_s")).observe(ttft)
            admitted.append(adm.rid)
            tokens_out += 1

        # a prefill token can complete a request (max_new=1, or eos): evict
        # before decode or the slot runs one step past its budget
        finished = self.sched.evict_finished(now)

        preempted = self.sched.ensure_capacity()
        active = self.sched.active_slots()
        if active:
            tokens_out += self._decode_tick(active)
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
        """One fused decode step over every slot (1 token each); inactive
        slots ride along at position 0 of the null block, as in the JAX
        package, so the batch shape is the slot count."""
        toks = self._tensor(self.sched.last_tok, torch.int64)
        pos = self._tensor(self.sched.pos, torch.int32)
        tables = self._live_tables(active)
        t_dec = self._clock()
        with self.tracer.scope(
            "decode", kind="compute", step=self.step_idx,
            active=len(active), tokens=len(active),
        ):
            logits = self._decode(self.params, self.pool, tables, toks, pos)
            next_tok = torch.argmax(logits, -1).tolist()
        now = self._clock()
        if self.registry is not None:
            self.registry.histogram(self._m("decode_step_s")).observe(now - t_dec)
        for s in active:
            self.sched.advance(s)
            self._emit(s, next_tok[s])
            self.sched.record_token(s, next_tok[s], now)
        return len(active)

    def _emit(self, slot: int, tok: int) -> None:
        rid = self.sched.slots[slot]
        self.streams[rid].append(StreamItem(self.step_idx, tok))

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
        engine steps."""
        reqs = list(self.sched.requests.values())
        return {**aggregate_metrics(reqs, wall=self._clock()),
                "steps": self.step_idx}

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
        self.step_idx = 0
        self._base = self._raw_clock()


# ---------------------------------------------------------------------------
# Workload (a copy of repro.core.simkit.workload's RequestSpec and
# poisson_requests, which the JAX package's CLI builds on)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RequestSpec:
    rid: int
    arrival: float          # seconds
    prompt_len: int
    max_new: int


def poisson_requests(
    n: int,
    rate: float,
    *,
    prompt_lens: tuple[int, ...] = (16, 32, 64, 128, 256),
    max_new_range: tuple[int, int] = (4, 48),
    seed: int = 0,
) -> list[RequestSpec]:
    """Poisson arrivals at ``rate``/s with mixed prompt/generation lengths;
    ``max_new_range`` is inclusive on both ends."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        out.append(RequestSpec(
            rid=i,
            arrival=t,
            prompt_len=int(rng.choice(prompt_lens)),
            max_new=int(rng.integers(*max_new_range, endpoint=True)),
        ))
    return out


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
):
    """The CLI's workload: Poisson arrival specs, random token prompts
    and a ``ServeConfig`` sized so the worst request fits one slot —
    ``num_blocks=0`` sizes the pool for zero preemption (every slot can hold
    its worst case at once, plus the null block).  The same seed gives the
    same specs and prompts as ``repro.serve.server.make_poisson_workload``.
    Returns (specs, prompts by rid, serve_cfg)."""
    specs = poisson_requests(
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
