"""RWKV-6 ("Finch") blocks in PyTorch, counterpart of ``repro.models.rwkv``.

Time mix (ddlerp token shift through a small tanh-LoRA, data-dependent
per-channel decay ``w_t = exp(-exp(w0 + lora(x)))``, the per-head matrix
WKV state with bonus ``u``, a per-head group norm, the silu gate) and
channel mix (squared ReLU with a token-shift lerp), with the JAX functions'
parameter names, layouts and rounding points: the mixes, r, k, v, g and the
LoRA come out in the compute dtype; the decay and the group norm are float32
(``w0``, ``w_decay2``, ``u`` and ``ln_x`` enter float32 math uncast); the
normed output is cast back before the gate.

Only the state-free branch is ported: training's full-sequence forward,
where the recurrence runs through K5 (``kernels/wkv6``), the counterpart of
both state-free branches of the JAX ``time_mix_apply`` (``wkv6_chunked`` and
the Pallas kernel).  A carried state (prefill and decode) belongs to the RWKV
serving slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models.hooks import NULL_COLLECTOR, Collector
from repro_torch.models.layers import ParamBuilder, norm_apply, norm_init
from repro_torch.models.scan_utils import shift_tokens

MIX_NAMES = ("w", "k", "v", "r", "g")


def _refuse_state(state) -> None:
    if state is not None:
        raise NotImplementedError(
            "an RWKV-6 carried state (prefill and decode) is ported with the "
            "RWKV serving slice (ROADMAP queue 1, item 13)")


def time_mix_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    D = cfg.d_model
    r = cfg.rwkv.ddlerp_rank
    dr = cfg.rwkv.decay_rank
    H = cfg.num_heads
    hs = cfg.rwkv.head_size
    b.param("mu_x", (D,), init="zeros")
    b.param("mu", (5, D), init="zeros")
    b.param("w_mix1", (D, 5, r), fan_in=D)
    b.param("w_mix2", (5, r, D), fan_in=r)
    b.param("w_r", (D, D), fan_in=D)
    b.param("w_k", (D, D), fan_in=D)
    b.param("w_v", (D, D), fan_in=D)
    b.param("w_g", (D, D), fan_in=D)
    b.param("w_o", (D, D), fan_in=D, scale=1.0 / math.sqrt(2 * cfg.num_layers))
    b.param("w0", (D,), init="const", fill=-5.0)
    b.param("w_decay1", (D, dr), fan_in=D)
    b.param("w_decay2", (dr, D), fan_in=dr)
    b.param("u", (H, hs), init="normal", fan_in=hs)
    norm_init(b, "ln_x", D, "layernorm")  # per-head group norm scales


def time_mix_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                   state: dict | None = None, plain: bool = False,
                   collector: Collector = NULL_COLLECTOR
                   ) -> tuple[torch.Tensor, None]:
    """``x [B, S, D]`` -> ``(out [B, S, D], None)``; ``plain`` runs K5's
    plain version on any device.  Tags the decay ``wkv_decay`` just before
    K5 and its output ``wkv_out`` just after."""
    _refuse_state(state)
    B, S, D = x.shape
    H, hs = cfg.num_heads, cfg.rwkv.head_size
    dt = x.dtype
    xx = shift_tokens(x) - x
    xxx = x + xx * p["mu_x"].to(dt)
    lora = torch.tanh(torch.einsum("bsd,dnr->bsnr", xxx, p["w_mix1"].to(dt)))
    mm = torch.einsum("bsnr,nrd->nbsd", lora, p["w_mix2"].to(dt))
    mixed = {name: x + xx * (p["mu"][i].to(dt) + mm[i])
             for i, name in enumerate(MIX_NAMES)}
    r = mixed["r"] @ p["w_r"].to(dt)
    k = mixed["k"] @ p["w_k"].to(dt)
    v = mixed["v"] @ p["w_v"].to(dt)
    g = F.silu(mixed["g"] @ p["w_g"].to(dt))
    ww = p["w0"].float() + (mixed["w"] @ p["w_decay1"].to(dt)).float() @ (
        p["w_decay2"].float())
    w = collector.tag("wkv_decay", torch.exp(-torch.exp(ww)))  # [B,S,D] in (0,1)

    y, _ = wkv6(r.view(B, S, H, hs), k.view(B, S, H, hs), v.view(B, S, H, hs),
                w.view(B, S, H, hs), p["u"].float(), plain=plain)
    y = collector.tag("wkv_out", y)

    # per-head group norm, then gate and project
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yf = ((yf - mu) * torch.rsqrt(var + 64e-5)).reshape(B, S, D)
    yf = yf * p["ln_x"]["scale"].float() + p["ln_x"]["bias"].float()
    return (yf.to(dt) * g) @ p["w_o"].to(dt), None


def channel_mix_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    D, Fd = cfg.d_model, cfg.d_ff
    b.param("mu_k", (D,), init="zeros")
    b.param("mu_r", (D,), init="zeros")
    b.param("w_k", (D, Fd), fan_in=D)
    b.param("w_v", (Fd, D), fan_in=Fd, scale=1.0 / math.sqrt(2 * cfg.num_layers))
    b.param("w_r", (D, D), fan_in=D)


def channel_mix_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                      state: dict | None = None) -> tuple[torch.Tensor, None]:
    _refuse_state(state)
    dt = x.dtype
    xx = shift_tokens(x) - x
    xk = x + xx * p["mu_k"].to(dt)
    xr = x + xx * p["mu_r"].to(dt)
    k = torch.square(F.relu(xk @ p["w_k"].to(dt)))
    kv = k @ p["w_v"].to(dt)
    return torch.sigmoid(xr @ p["w_r"].to(dt)) * kv, None


def rwkv_block_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    norm_init(b, "ln1", cfg.d_model, cfg.norm_kind)
    norm_init(b, "ln2", cfg.d_model, cfg.norm_kind)
    time_mix_init(b.sub("att"), cfg)
    channel_mix_init(b.sub("ffn"), cfg)


def rwkv_block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                     state: dict | None = None, plain: bool = False,
                     collector: Collector = NULL_COLLECTOR
                     ) -> tuple[torch.Tensor, None]:
    """One RWKV-6 layer; ln1/ln2 go through K1, the recurrence through K5."""
    _refuse_state(state)
    h = norm_apply(p["ln1"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    a, _ = time_mix_apply(p["att"], cfg, h, plain=plain, collector=collector)
    x = x + collector.tag("att_resid", a)
    h = norm_apply(p["ln2"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    f, _ = channel_mix_apply(p["ffn"], cfg, h)
    return x + collector.tag("ffn_resid", f), None
