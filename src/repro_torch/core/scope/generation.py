"""Token-by-token generation with synchronized introspection (MegaScope §6.2,
Fig. 4), counterpart of ``repro.core.scope.generation``: each decode step
records the chosen token, its probability, the top-k decision distribution,
and all registered probe captures.

One prefill of the prompt over a dense cache (``lm.init_cache``: the KV
cache, and the recurrent families' carried state), then one-token steps;
greedy.  Each step feeds the token it chose.  (The JAX function takes its
token once, before its loop, and feeds that first token at every step:
ROADMAP R6.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.scope.collector import ScopeCollector
from repro_torch.models import layers as L
from repro_torch.models import lm


@dataclass
class GenerationRecord:
    step: int
    token: int
    prob: float
    topk_tokens: list[int]
    topk_probs: list[float]
    captures: dict[str, Any] = field(default_factory=dict)


def _flat_captures(aux: dict) -> dict[str, Any]:
    """Flatten ``lm.forward``'s aux captures (grouped by segment, with
    layer leaves stacked over a leading layer axis) into the flat
    ``{"tag.compress": value}`` record layout.  When a later segment repeats
    a key, that occurrence is disambiguated with its segment prefix
    (``"seg1/tag.compress"``)."""
    out: dict[str, Any] = {}
    for seg, caps in aux.get("captures", {}).items():
        for k, v in caps.items():
            out[k if k not in out else f"{seg}/{k}"] = v
    return out


def _to_host(tree):
    """Numpy copies; bfloat16 leaves as float32 (numpy has no bfloat16 of
    its own; the cast is exact)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    t = tree.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@torch.no_grad()
def generate_with_scope(
    cfg: ModelConfig,
    params: dict,
    prompt_tokens: torch.Tensor,   # [B, S] (B=1 recommended for viz)
    n_steps: int,
    scope: ScopeCollector | None = None,
    top_k: int = 8,
) -> tuple[list[GenerationRecord], torch.Tensor]:
    """Returns ``(records, tokens [B, n_steps])``; ``params`` in the compute
    dtype on the tokens' device (``lm.cast_params``)."""
    if cfg.input_kind != "tokens":
        raise ValueError(f"{cfg.name}: generate_with_scope serves token archs")
    B, S = prompt_tokens.shape
    cache = lm.init_cache(cfg, B, S + n_steps, device=prompt_tokens.device)
    scope = scope or ScopeCollector()

    scope.new_draws()
    hidden, aux = lm.forward(cfg, params, prompt_tokens, cache=cache,
                             cache_pos=0, collector=scope)
    logits = L.logits_fn(params, cfg, hidden[:, -1:, :])[:, 0]
    records: list[GenerationRecord] = []
    toks = []
    for i in range(n_steps):
        tok = logits.argmax(-1)
        probs = torch.softmax(logits.float(), -1)
        tk_p, tk_i = torch.topk(probs[0], top_k)
        captures = _to_host({**_flat_captures(aux), **scope.drain()})
        records.append(GenerationRecord(
            step=i,
            token=int(tok[0]),
            prob=float(probs[0, tok[0]]),
            topk_tokens=tk_i.tolist(),
            topk_probs=tk_p.tolist(),
            captures=captures,
        ))
        toks.append(tok)
        scope.new_draws()
        hidden, aux = lm.forward(cfg, params, tok[:, None], cache=cache,
                                 cache_pos=S + i, collector=scope)
        logits = L.logits_fn(params, cfg, hidden)[:, 0]
    return records, torch.stack(toks, dim=1)
