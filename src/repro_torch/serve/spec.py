"""Speculative-decoding draft proposers for MegaServe.

Copied from ``repro.serve.spec`` (host-side, numpy only).  A drafter guesses
the next few tokens of a request so the target model can *verify* them all in
one batched forward (``engine.make_spec_verify_step``) instead of generating
them one step at a time.  Drafters are stateless given the token history, so
preemption-by-recompute (which replays ``prompt + generated`` through a fresh
prefill) cannot desynchronize them: the same history always yields the same
proposal, which keeps greedy speculative serving token-identical to the
non-speculative path across preemption round trips.

``NGramDrafter`` is prompt-lookup decoding: it bets that the sequence's
recent suffix has occurred before and proposes whatever followed that
earlier occurrence; it proposes nothing when the history has no match, and
the server then runs a plain decode step.  ``RandomDrafter`` is the
adversarial one.  Anything with ``propose(history, k) -> list[int]`` slots
into ``MegaServe(..., drafter=...)``.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Drafter(Protocol):
    """Proposes up to ``k`` continuation tokens for a token history."""

    def propose(self, history: list[int], k: int) -> list[int]:
        """Return 0..k draft tokens continuing ``history``.  An empty list
        means "no guess" — the server then runs a plain decode step."""
        ...


class NGramDrafter:
    """Prompt-lookup drafter: longest-suffix n-gram match over the history.

    For ``n`` from ``max_ngram`` down to ``min_ngram``, the last ``n`` tokens
    are searched for in the earlier history (most recent occurrence first);
    on a hit, the ``k`` tokens that followed the match are proposed.  The
    scan is O(len(history) * max_ngram) per call, bounded by ``max_history``.
    """

    def __init__(self, max_ngram: int = 4, min_ngram: int = 1,
                 max_history: int = 4096):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(f"bad ngram range [{min_ngram}, {max_ngram}]")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.max_history = max_history

    def propose(self, history: list[int], k: int) -> list[int]:
        if k <= 0:
            return []
        hist = history[-self.max_history:]
        L = len(hist)
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            suffix = hist[L - n:]
            # the most recent occurrence with a full-length continuation
            # wins; a match butted against the end of history only yields a
            # truncated draft, kept as the fallback (verification costs the
            # same at any draft length, so longer proposals are free)
            best: list[int] = []
            for i in range(L - n - 1, -1, -1):
                if hist[i : i + n] == suffix:
                    cont = hist[i + n : i + n + k]
                    if len(cont) == k:
                        return list(cont)
                    if len(cont) > len(best):
                        best = list(cont)
            if best:
                return best
        return []


class RandomDrafter:
    """Adversarial drafter: proposes uniform-random tokens (acceptance ~1/V),
    which exercises the draft-length adaptation that shuts speculation off."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seed = seed

    def propose(self, history: list[int], k: int) -> list[int]:
        if k <= 0:
            return []
        # seeded from (seed, history): stateless given the token history, so
        # preemption-by-recompute replays identically
        rng = np.random.default_rng([self.seed, len(history), *history[-8:]])
        return rng.integers(2, self.vocab_size, size=k).tolist()


def get_drafter(kind: str, *, vocab_size: int = 0, max_ngram: int = 4,
                min_ngram: int = 1, seed: int = 0) -> Drafter:
    """CLI factory: ``"ngram"`` or ``"random"`` (adversarial)."""
    if kind == "ngram":
        return NGramDrafter(max_ngram=max_ngram, min_ngram=min_ngram)
    if kind == "random":
        return RandomDrafter(vocab_size, seed=seed)
    raise ValueError(f"unknown drafter {kind!r}")
