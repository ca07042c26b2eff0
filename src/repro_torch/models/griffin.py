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

Only the state-free branch is ported: training's full-sequence forward,
where every recurrence runs through K6 (``kernels/rglru``), the counterpart
of both state-free branches of the JAX ``rglru_apply`` (``lru_scan`` and the
Pallas kernel, which clamps: P7).  A carried state (the conv context and h,
for prefill and decode) belongs to the Griffin serving slice.
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
from repro_torch.models.scan_utils import causal_conv1d


def _refuse_state(state) -> None:
    if state is not None:
        raise NotImplementedError(
            "a Griffin carried state (prefill and decode) is ported with the "
            "Griffin serving slice (ROADMAP queue 1, item 13)")


def rglru_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    W = cfg.lru_width
    b.param("w_a", (W, W), fan_in=W)
    b.param("b_a", (W,), init="zeros")
    b.param("w_i", (W, W), fan_in=W)
    b.param("b_i", (W,), init="zeros")
    # Lambda init so that softplus gives decay in a useful range (Griffin A.2)
    b.param("lam", (W,), init="uniform", scale=1.0)


def rglru_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                h0: torch.Tensor | None = None, *, plain: bool = False,
                collector: Collector = NULL_COLLECTOR
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, W]`` -> ``(h [B, S, W]`` in x's dtype, ``h_last [B, W]``
    float32); ``plain`` runs K6's plain version on any device.  Tags the
    decay ``rglru_decay`` (the scan's a; beta keeps the untagged log a, as
    in JAX)."""
    _refuse_state(h0)
    dt = x.dtype
    r = torch.sigmoid(x @ p["w_a"].to(dt) + p["b_a"].to(dt)).float()
    i = torch.sigmoid(x @ p["w_i"].to(dt) + p["b_i"].to(dt))
    lam = p["lam"].float()
    log_a = -cfg.griffin.c * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = collector.tag("rglru_decay", torch.exp(log_a))
    # input normalisation sqrt(1 - a^2), computed stably
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    b_in = beta * (i * x).float()
    h, h_last = rglru_scan(a, b_in, plain=plain)
    return h.to(dt), h_last


def recurrent_block_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    D, W = cfg.d_model, cfg.lru_width
    b.param("w_gate", (D, W), fan_in=D)
    b.param("w_x", (D, W), fan_in=D)
    b.param("conv_w", (cfg.griffin.conv_width, W), fan_in=cfg.griffin.conv_width)
    b.param("conv_b", (W,), init="zeros")
    rglru_init(b.sub("rglru"), cfg)
    b.param("w_out", (W, D), fan_in=W, scale=1.0 / math.sqrt(2 * cfg.num_layers))


def recurrent_block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                          state: dict | None = None, plain: bool = False,
                          collector: Collector = NULL_COLLECTOR
                          ) -> tuple[torch.Tensor, None]:
    _refuse_state(state)
    dt = x.dtype
    gate = F.gelu(x @ p["w_gate"].to(dt), approximate="tanh")
    y = causal_conv1d(x @ p["w_x"].to(dt), p["conv_w"], p["conv_b"])
    y, _ = rglru_apply(p["rglru"], cfg, y, plain=plain, collector=collector)
    y = collector.tag("rglru_out", y)
    return (gate * y) @ p["w_out"].to(dt), None


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
                        plain: bool = False,
                        collector: Collector = NULL_COLLECTOR
                        ) -> tuple[torch.Tensor, None]:
    """One Griffin layer: ln1/ln2 through K1, the recurrence through K6, the
    windowed attention through K2."""
    _refuse_state(state)
    h = norm_apply(p["ln1"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    if kind == "rec":
        a, _ = recurrent_block_apply(p["mix"], cfg, h, plain=plain,
                                     collector=collector)
    else:
        a = gqa_apply(p["mix"], cfg, h, positions=positions,
                      window=cfg.griffin.window, plain=plain, collector=collector)
    x = x + collector.tag("att_resid", a)
    h = norm_apply(p["ln2"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    f = mlp_apply(p["mlp"], cfg, h, collector)
    return x + collector.tag("ffn_resid", f), None
