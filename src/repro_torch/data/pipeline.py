"""Deterministic synthetic token pipeline with background prefetch, a copy
of ``repro.data.pipeline`` (pure numpy).

Batch content is a pure function of ``(seed, step, host)``, so the same
configuration gives the JAX package's batches bit for bit, and a run that
resumes at step n replays the batches of an uninterrupted one from there.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    bos_id: int = 1
    mean_doc_len: int = 256
    n_hosts: int = 1
    host_id: int = 0


class SyntheticTokens:
    """Markov-ish synthetic LM stream (learnable structure, not pure noise)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.host_batch = cfg.global_batch // cfg.n_hosts
        # the generative rule is a dataset-level constant (learnable); per-step
        # randomness only drives starts and noise
        rule_rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 977]))
        self._a = int(rule_rng.integers(2, 64))
        self._b = int(rule_rng.integers(0, cfg.vocab_size))

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id])
        )
        B, S = self.host_batch, cfg.seq_len
        # next-token structure: x_{t+1} = (a * x_t + b) % V with noise
        x = np.empty((B, S + 1), np.int64)
        x[:, 0] = rng.integers(0, cfg.vocab_size, B)
        for t in range(S):
            x[:, t + 1] = (self._a * x[:, t] + self._b) % cfg.vocab_size
        noise = rng.random((B, S + 1)) < 0.05
        x[noise] = rng.integers(0, cfg.vocab_size, noise.sum())
        # pack pseudo-documents: BOS resets + mask
        mask = np.ones((B, S), np.float32)
        doc_break = rng.random((B, S)) < (1.0 / cfg.mean_doc_len)
        x[:, 1:][doc_break] = cfg.bos_id
        tokens = x[:, :S].astype(np.int32)
        targets = x[:, 1 : S + 1].astype(np.int32)
        return {"tokens": tokens, "targets": targets, "loss_mask": mask}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-bounded), start offset for resume."""

    def __init__(self, source: SyntheticTokens, depth: int = 2, start_step: int = 0):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put(self.source.batch_at(step), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def next(self) -> dict[str, np.ndarray]:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)


def make_pipeline(cfg: DataConfig, *, prefetch: int = 2, start_step: int = 0):
    return Prefetcher(SyntheticTokens(cfg), depth=prefetch, start_step=start_step)
