"""Griffin / RecurrentGemma blocks in PyTorch, counterpart of
``repro.models.griffin``.

The temporal-mixing layers follow the (rec, rec, attn) pattern of
arXiv:2402.19427.  A recurrent block is ``gelu(x W_gate) * rglru(conv1d(x
W_x))`` projected back by ``w_out``, with the RG-LRU

    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t),
    a_t = exp(-c * softplus(lam) * r_t);

an attention block is MQA over a sliding window.  Parameter names, layouts
and rounding points are the JAX functions': the gates r and i are sigmoids
in x's dtype, r then float32; log a, a and the input scale beta are float32
(``lam`` enters float32 math uncast); ``i * x`` is taken in x's dtype, then
float32; h is cast back to x's dtype; the output gate is tanh-gelu and
``gate * y`` is taken in x's dtype.

The recurrence dispatches as the JAX ``rglru_apply`` does: training's
state-free full sequence runs K6 (``kernels/rglru``), the counterpart of
the Pallas kernel (which clamps: P7); a carried ``h0`` or a single token
runs ``lru_scan`` (prefill segments and decode).  A recurrent block's state
is ``{"conv" [B, width - 1, W], "h" [B, W]}``, an attention block's its K/V
(a dense cache, or the paged pool when serving); see
:func:`griffin_init_state`.  The block functions return the new recurrent
state beside their output, as JAX's do; attention writes its K/V in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru import rglru_scan
from repro_torch.models.hooks import NULL_COLLECTOR, Collector
from repro_torch.models.layers import (
    ParamBuilder,
    gqa_apply,
    gqa_init,
    mlp_apply,
    mlp_init,
    norm_apply,
    norm_init,
)
from repro_torch.kernels.paged_attention.ops import PagedInfo
from repro_torch.models.scan_utils import causal_conv1d, lru_scan


def rglru_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    W = cfg.lru_width
    b.param("w_a", (W, W), ("embed_w", "qkv"), fan_in=W)
    b.param("b_a", (W,), ("qkv",), init="zeros")
    b.param("w_i", (W, W), ("embed_w", "qkv"), fan_in=W)
    b.param("b_i", (W,), ("qkv",), init="zeros")
    # Lambda init so that softplus gives decay in a useful range (Griffin A.2)
    b.param("lam", (W,), ("qkv",), init="uniform", scale=1.0)


def rglru_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                h0: torch.Tensor | None = None, *, plain: bool = False,
                collector: Collector = NULL_COLLECTOR
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, W]`` -> ``(h [B, S, W]`` in x's dtype, ``h_last [B, W]``
    float32); ``plain`` runs K6's plain version on any device.  Tags the
    decay ``rglru_decay`` (the scan's a; beta keeps the untagged log a, as
    in JAX).  K6 takes the state-free scans of more than one token; ``h0``
    or one token goes to ``lru_scan``."""
    dt = x.dtype
    r = torch.sigmoid(x @ p["w_a"].to(dt) + p["b_a"].to(dt)).float()
    i = torch.sigmoid(x @ p["w_i"].to(dt) + p["b_i"].to(dt))
    lam = p["lam"].float()
    log_a = -cfg.griffin.c * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = collector.tag("rglru_decay", torch.exp(log_a))
    # input normalisation sqrt(1 - a^2), computed stably
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    b_in = beta * (i * x).float()
    if h0 is None and x.shape[1] > 1:
        h, h_last = rglru_scan(a, b_in, plain=plain)
    else:
        h, h_last = lru_scan(a, b_in, h0)
    return h.to(dt), h_last


def recurrent_block_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    D, W = cfg.d_model, cfg.lru_width
    b.param("w_gate", (D, W), ("embed_w", "qkv"), fan_in=D)
    b.param("w_x", (D, W), ("embed_w", "qkv"), fan_in=D)
    b.param("conv_w", (cfg.griffin.conv_width, W), ("conv", "qkv"), fan_in=cfg.griffin.conv_width)
    b.param("conv_b", (W,), ("qkv",), init="zeros")
    rglru_init(b.sub("rglru"), cfg)
    b.param("w_out", (W, D), ("qkv", "embed_w"),
            fan_in=W, scale=1.0 / math.sqrt(2 * cfg.num_layers))


def recurrent_block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                          state: dict | None = None, plain: bool = False,
                          collector: Collector = NULL_COLLECTOR
                          ) -> tuple[torch.Tensor, dict | None]:
    dt = x.dtype
    gate = F.gelu(x @ p["w_gate"].to(dt), approximate="tanh")
    y, conv_new = causal_conv1d(x @ p["w_x"].to(dt), p["conv_w"], p["conv_b"],
                                None if state is None else state["conv"])
    y, h_last = rglru_apply(p["rglru"], cfg, y,
                            None if state is None else state["h"],
                            plain=plain, collector=collector)
    y = collector.tag("rglru_out", y)
    out = (gate * y) @ p["w_out"].to(dt)
    return out, None if state is None else {"conv": conv_new, "h": h_last}


def griffin_block_init(b: ParamBuilder, cfg: ModelConfig, kind: str) -> None:
    norm_init(b, "ln1", cfg.d_model, cfg.norm_kind)
    norm_init(b, "ln2", cfg.d_model, cfg.norm_kind)
    if kind == "rec":
        recurrent_block_init(b.sub("mix"), cfg)
    else:
        gqa_init(b.sub("mix"), cfg)
    mlp_init(b.sub("mlp"), cfg)


def griffin_block_apply(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                        *, positions: torch.Tensor, state: dict | None = None,
                        cache_pos: int | None = None,
                        paged: PagedInfo | None = None, plain: bool = False,
                        collector: Collector = NULL_COLLECTOR
                        ) -> tuple[torch.Tensor, dict | None]:
    """One Griffin layer: ln1/ln2 through K1; a recurrent block's scan
    through K6 (training) or ``lru_scan`` (a carried state); the windowed
    attention through K2 (training), the dense cache's attention
    (``state`` a dense cache written at ``cache_pos``) or K3 (``paged``:
    ``state`` is the pool's ``{"k", "v"}``).  Returns ``(x, the recurrent
    block's new state or None)``."""
    h = norm_apply(p["ln1"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    new_state = None
    if kind == "rec":
        a, new_state = recurrent_block_apply(p["mix"], cfg, h, state=state,
                                             plain=plain, collector=collector)
    else:
        paged_pool = state if paged is not None else None
        a = gqa_apply(p["mix"], cfg, h, positions=positions,
                      window=cfg.griffin.window, pool=paged_pool, paged=paged,
                      plain=plain, collector=collector,
                      cache=None if paged is not None else state,
                      cache_pos=cache_pos)
    x = x + collector.tag("att_resid", a)
    h = norm_apply(p["ln2"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    f = mlp_apply(p["mlp"], cfg, h, collector)
    return x + collector.tag("ffn_resid", f), new_state


def griffin_init_state(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                       device: torch.device | str = "cpu") -> dict:
    """One layer's carry: float32 ``conv``/``h`` for a recurrent block,
    a bfloat16 full-length linear K/V cache for an attention block (the
    window mask limits its reach)."""
    if kind == "rec":
        W = cfg.lru_width
        return {"conv": torch.zeros((batch, cfg.griffin.conv_width - 1, W),
                                    dtype=torch.float32, device=device),
                "h": torch.zeros((batch, W), dtype=torch.float32, device=device)}
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {n: torch.zeros(shape, dtype=torch.bfloat16, device=device)
            for n in ("k", "v")}
