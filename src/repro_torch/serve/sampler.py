"""Token sampling and speculative-decoding acceptance.

Counterpart of ``repro.serve.sampler``, in two halves:

* ``sample`` — on the device, over a ``[B, V]`` logit batch: greedy,
  temperature, top-k and top-p (nucleus).  It takes a ``torch.Generator``
  where the JAX function takes a key, and keeps its rule that no generator
  means greedy argmax, whatever the temperature.  MegaServe and static
  serving call it without one, as the JAX package does, so every served
  token is greedy (ROADMAP R7).
* ``greedy_verify`` / ``rejection_verify`` — host-side numpy, copied: the
  MegaServe loop's acceptance of a speculative verify step's predictions.
  Greedy acceptance keeps the stream token-identical to non-speculative
  greedy decoding; rejection sampling keeps the target model's sampling
  distribution for any deterministic drafter.
"""

from __future__ import annotations

import numpy as np
import torch


def filter_logits(logits: torch.Tensor, *, temperature: float, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """The float32 logits ``sample`` draws from: divided by ``temperature``,
    then ``-inf`` outside the top-k (ties with the k-th kept, as JAX's
    ``logits < kth`` mask keeps them) and outside the smallest set of tokens
    whose probability reaches ``top_p`` (the most likely token always in
    it).  Top-k applies first."""
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -torch.inf)
    if 0.0 < top_p < 1.0:
        sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True,
                                             stable=True)
        probs = torch.softmax(sorted_logits, dim=-1)
        # drop a token once the mass before it already covers top_p, so the
        # minimal covering set (with the argmax) is kept
        exceeded = torch.cumsum(probs, dim=-1) - probs > top_p
        sorted_logits = sorted_logits.masked_fill(exceeded, -torch.inf)
        logits = torch.empty_like(logits).scatter_(-1, sort_idx, sorted_logits)
    return logits


def sample(
    logits: torch.Tensor,  # [B, V]
    generator: torch.Generator | None = None,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
) -> torch.Tensor:
    """One token per row, int64 ``[B]``.

    ``temperature <= 0`` (or no ``generator``) is greedy argmax.  Otherwise
    one categorical draw a row from :func:`filter_logits`, from
    ``generator``'s stream (its device must be the logits')."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature=temperature,
                                        top_k=top_k, top_p=top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


# ---------------------------------------------------------------------------
# Speculative-decoding acceptance (host side)
# ---------------------------------------------------------------------------
#
# The verification forward feeds one slot the token row
# ``[t_0, d_1, ..., d_k, <pad>...]`` (t_0 = the last committed token, d_i =
# the drafter's proposals) and returns the target model's prediction for the
# position after each row entry.  Row ``i`` therefore judges draft token
# ``d_{i+1}``; the first row whose verdict disagrees supplies the correction,
# and full acceptance promotes row ``k``'s prediction to a bonus token.
# Every step emits between 1 and k+1 tokens.


def greedy_verify(
    target: np.ndarray,      # [Q] greedy target predictions (argmax per row)
    draft: list[int],        # k <= Q - 1 proposed tokens
) -> tuple[int, list[int]]:
    """Greedy acceptance: returns ``(n_accepted, emitted)``.

    ``emitted`` is the accepted draft prefix plus one correction/bonus token,
    so it always holds ``n_accepted + 1`` tokens and exactly reproduces what
    non-speculative greedy decoding would have generated.
    """
    n = 0
    while n < len(draft) and int(target[n]) == int(draft[n]):
        n += 1
    return n, [int(d) for d in draft[:n]] + [int(target[n])]


def _renormalize(p: np.ndarray) -> np.ndarray:
    s = p.sum()
    if s <= 0.0:  # degenerate row: fall back to uniform
        return np.full_like(p, 1.0 / len(p))
    return p / s


def rejection_verify(
    target_probs: np.ndarray,  # [Q, V] target distribution per row
    draft: list[int],          # k <= Q - 1 proposed tokens
    rng: np.random.Generator,
) -> tuple[int, list[int]]:
    """Rejection-sampling acceptance for a *deterministic* drafter.

    Draft token ``d`` at row ``i`` is accepted with probability
    ``p_i(d)`` (the proposal places mass 1 on ``d``, so ``min(1, p/q) = p``).
    On rejection the emitted token is drawn from the residual distribution
    ``normalize(max(0, p_i - q_i))`` — here ``p_i`` with ``d`` zeroed out —
    which keeps the marginal distribution of every emitted token exactly the
    target model's (Leviathan et al., 2023).  Full acceptance samples the
    bonus token from row ``k``.  Returns ``(n_accepted, emitted)``.
    """
    emitted: list[int] = []
    n = 0
    for i, d in enumerate(draft):
        p = np.asarray(target_probs[i], np.float64)
        if rng.random() < p[int(d)]:
            emitted.append(int(d))
            n += 1
            continue
        residual = p.copy()
        residual[int(d)] = 0.0
        residual = _renormalize(residual)
        emitted.append(int(rng.choice(len(residual), p=residual)))
        return n, emitted
    p = _renormalize(np.asarray(target_probs[len(draft)], np.float64))
    emitted.append(int(rng.choice(len(p), p=p)))
    return n, emitted
