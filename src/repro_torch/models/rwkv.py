"""RWKV-6 ("Finch") blocks in PyTorch, counterpart of ``repro.models.rwkv``.

Time mix (ddlerp token shift through a small tanh-LoRA, data-dependent
per-channel decay ``w_t = exp(-exp(w0 + lora(x)))``, the per-head matrix
WKV state with bonus ``u``, a per-head group norm, the silu gate) and
channel mix (squared ReLU with a token-shift lerp), with the JAX functions'
parameter names, layouts and rounding points: the mixes, r, k, v, g and the
LoRA come out in the compute dtype; the decay and the group norm are float32
(``w0``, ``w_decay2``, ``u`` and ``ln_x`` enter float32 math uncast); the
normed output is cast back before the gate.

The recurrence dispatches as the JAX ``time_mix_apply`` does: one token
runs the exact ``wkv6_sequential`` (decode), a carried state over more
tokens runs ``wkv6_chunked`` (prefill segments; the sequential form where
the width is not a multiple of 32), and training's state-free full
sequence runs K5 (``kernels/wkv6``), the counterpart of the Pallas kernel.
A state is ``{"att": {"x_prev" [B, D], "wkv" [B, H, K, V]}, "ffn":
{"x_prev" [B, D]}}`` (:func:`rwkv_init_state`); the functions return the
new one beside their output, as JAX's do, and leave the old one as it is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models.hooks import NULL_COLLECTOR, Collector
from repro_torch.models.layers import ParamBuilder, norm_apply, norm_init
from repro_torch.models.scan_utils import shift_tokens, wkv6_chunked, wkv6_sequential

MIX_NAMES = ("w", "k", "v", "r", "g")


def time_mix_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    D = cfg.d_model
    r = cfg.rwkv.ddlerp_rank
    dr = cfg.rwkv.decay_rank
    H = cfg.num_heads
    hs = cfg.rwkv.head_size
    b.param("mu_x", (D,), ("embed_w",), init="zeros")
    b.param("mu", (5, D), (None, "embed_w"), init="zeros")
    b.param("w_mix1", (D, 5, r), ("embed_w", None, None), fan_in=D)
    b.param("w_mix2", (5, r, D), (None, None, "embed_w"), fan_in=r)
    b.param("w_r", (D, D), ("embed_w", "qkv"), fan_in=D)
    b.param("w_k", (D, D), ("embed_w", "qkv"), fan_in=D)
    b.param("w_v", (D, D), ("embed_w", "qkv"), fan_in=D)
    b.param("w_g", (D, D), ("embed_w", "qkv"), fan_in=D)
    b.param("w_o", (D, D), ("qkv", "embed_w"), fan_in=D, scale=1.0 / math.sqrt(2 * cfg.num_layers))
    b.param("w0", (D,), ("embed_w",), init="const", fill=-5.0)
    b.param("w_decay1", (D, dr), ("embed_w", None), fan_in=D)
    b.param("w_decay2", (dr, D), (None, "embed_w"), fan_in=dr)
    b.param("u", (H, hs), (None, None), init="normal", fan_in=hs)
    norm_init(b, "ln_x", D, "layernorm")  # per-head group norm scales


def time_mix_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                   state: dict | None = None, plain: bool = False,
                   collector: Collector = NULL_COLLECTOR
                   ) -> tuple[torch.Tensor, dict | None]:
    """``x [B, S, D]`` -> ``(out [B, S, D], new state or None)``; ``plain``
    runs K5's plain version on any device.  Tags the decay ``wkv_decay``
    just before the recurrence and its output ``wkv_out`` just after."""
    B, S, D = x.shape
    H, hs = cfg.num_heads, cfg.rwkv.head_size
    dt = x.dtype
    xx = shift_tokens(x, None if state is None else state["x_prev"]) - x
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

    rh, kh, vh, wh = (t.view(B, S, H, hs) for t in (r, k, v, w))
    s0 = None if state is None else state["wkv"]
    if S == 1:
        y, s_new = wkv6_sequential(rh, kh, vh, wh, p["u"].float(), s0)
    elif s0 is None:
        y, s_new = wkv6(rh, kh, vh, wh, p["u"].float(), plain=plain)
    else:
        y, s_new = wkv6_chunked(rh, kh, vh, wh, p["u"].float(), s0)
    y = collector.tag("wkv_out", y)

    # per-head group norm, then gate and project
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yf = ((yf - mu) * torch.rsqrt(var + 64e-5)).reshape(B, S, D)
    yf = yf * p["ln_x"]["scale"].float() + p["ln_x"]["bias"].float()
    out = (yf.to(dt) * g) @ p["w_o"].to(dt)
    return out, None if state is None else {"x_prev": x[:, -1], "wkv": s_new}


def channel_mix_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    D, Fd = cfg.d_model, cfg.d_ff
    b.param("mu_k", (D,), ("embed_w",), init="zeros")
    b.param("mu_r", (D,), ("embed_w",), init="zeros")
    b.param("w_k", (D, Fd), ("embed_w", "mlp_w"), fan_in=D)
    b.param("w_v", (Fd, D), ("mlp_w", "embed_w"),
            fan_in=Fd, scale=1.0 / math.sqrt(2 * cfg.num_layers))
    b.param("w_r", (D, D), ("embed_w", "qkv"), fan_in=D)


def channel_mix_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                      state: dict | None = None
                      ) -> tuple[torch.Tensor, dict | None]:
    dt = x.dtype
    xx = shift_tokens(x, None if state is None else state["x_prev"]) - x
    xk = x + xx * p["mu_k"].to(dt)
    xr = x + xx * p["mu_r"].to(dt)
    k = torch.square(F.relu(xk @ p["w_k"].to(dt)))
    kv = k @ p["w_v"].to(dt)
    out = torch.sigmoid(xr @ p["w_r"].to(dt)) * kv
    return out, None if state is None else {"x_prev": x[:, -1]}


def rwkv_block_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    norm_init(b, "ln1", cfg.d_model, cfg.norm_kind)
    norm_init(b, "ln2", cfg.d_model, cfg.norm_kind)
    time_mix_init(b.sub("att"), cfg)
    channel_mix_init(b.sub("ffn"), cfg)


def rwkv_block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                     state: dict | None = None, plain: bool = False,
                     collector: Collector = NULL_COLLECTOR
                     ) -> tuple[torch.Tensor, dict | None]:
    """One RWKV-6 layer; ln1/ln2 go through K1, a state-free recurrence
    through K5.  Returns ``(x, new state or None)``."""
    h = norm_apply(p["ln1"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    a, att_new = time_mix_apply(
        p["att"], cfg, h, state=None if state is None else state["att"],
        plain=plain, collector=collector)
    x = x + collector.tag("att_resid", a)
    h = norm_apply(p["ln2"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    f, ffn_new = channel_mix_apply(
        p["ffn"], cfg, h, state=None if state is None else state["ffn"])
    x = x + collector.tag("ffn_resid", f)
    return x, None if state is None else {"att": att_new, "ffn": ffn_new}


def rwkv_init_state(cfg: ModelConfig, batch: int,
                    device: torch.device | str = "cpu") -> dict:
    """One layer's decode/prefill carry state, float32 (stacked over layers
    by ``lm.init_cache``)."""
    H, hs = cfg.num_heads, cfg.rwkv.head_size
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"att": {"x_prev": z(batch, cfg.d_model), "wkv": z(batch, H, hs, hs)},
            "ffn": {"x_prev": z(batch, cfg.d_model)}}
