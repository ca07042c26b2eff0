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
from repro_torch.models.split import WHOLE, Split

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
                   collector: Collector = NULL_COLLECTOR, split: Split | None = None
                   ) -> tuple[torch.Tensor, dict | None]:
    """``x [B, S, D]`` -> ``(out [B, S, D], new state or None)``; ``plain``
    runs K5's plain version on any device.  Tags the decay ``wkv_decay``
    just before the recurrence and its output ``wkv_out`` just after.
    Under a tensor ``split`` (training: no state, no tags) the token shift
    and the five mixes run whole, enter the slices together, and each slice
    runs :func:`_time_mix_heads` on its heads."""
    dt = x.dtype
    xx = shift_tokens(x, None if state is None else state["x_prev"]) - x
    xxx = x + xx * p["mu_x"].to(dt)
    lora = torch.tanh(torch.einsum("bsd,dnr->bsnr", xxx, p["w_mix1"].to(dt)))
    mm = torch.einsum("bsnr,nrd->nbsd", lora, p["w_mix2"].to(dt))
    if split is not None and split.tensor:
        # the boundary: the five mixes, whole, enter the slices together
        mixed = x + xx * (p["mu"].to(dt)[:, None, None] + mm)
        return split.sum(lambda t: _time_mix_heads(
            p, cfg, split.enter(mixed).unbind(0), split, t, plain)[0]).to(dt), None
    mixed = [x + xx * (p["mu"][i].to(dt) + mm[i]) for i in range(len(MIX_NAMES))]
    out, s_new = _time_mix_heads(p, cfg, mixed, WHOLE, 0, plain,
                                 None if state is None else state["wkv"], collector)
    return out, None if state is None else {"x_prev": x[:, -1], "wkv": s_new}


def _time_mix_heads(p: dict, cfg: ModelConfig, mixed, split: Split, t: int,
                    plain: bool, s0: torch.Tensor | None = None,
                    collector: Collector = NULL_COLLECTOR
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The time mix from its five mixes (``mixed``, ``[B, S, D]`` each in
    ``MIX_NAMES``' order) on slice ``t``'s heads: ``(out, new WKV state)``.
    r, k, v and g on the ``H / tp`` heads (``w_r``, ``w_k``, ``w_v``, ``w_g``
    sliced by output columns), the decay, the bonus ``u`` and ``ln_x`` on
    their channels (kept whole, entered: their gradients sum over the
    slices), K5 and the per-head group norm on those heads, ``w_o`` sliced
    by rows (``split.out``: float32 under the split).  With :data:`WHOLE`
    this is the fused time mix: all heads, ``s0`` carried."""
    B, S, D = mixed[0].shape
    H, hs = cfg.num_heads // split.tp, cfg.rwkv.head_size
    dt = mixed[0].dtype
    mx = dict(zip(MIX_NAMES, mixed))
    proj = lambda name, w: mx[name] @ w.to(dt)  # noqa: E731
    r, k, v = (proj(n, split.cut(p[f"w_{n}"], 1, t)) for n in ("r", "k", "v"))
    g = F.silu(proj("g", split.cut(p["w_g"], 1, t)))
    whole = lambda leaf, dim: split.narrow(split.enter(leaf), dim, t)  # noqa: E731
    ww = whole(p["w0"], 0).float() + proj("w", split.enter(p["w_decay1"])).float() @ (
        whole(p["w_decay2"], 1).float())
    w = collector.tag("wkv_decay", torch.exp(-torch.exp(ww)))  # [B,S,D] in (0,1)

    rh, kh, vh, wh = (u.view(B, S, H, hs) for u in (r, k, v, w))
    u = whole(p["u"], 0).float()
    if S == 1:
        y, s_new = wkv6_sequential(rh, kh, vh, wh, u, s0)
    elif s0 is None:
        y, s_new = wkv6(rh, kh, vh, wh, u, plain=plain)
    else:
        y, s_new = wkv6_chunked(rh, kh, vh, wh, u, s0)
    y = collector.tag("wkv_out", y)

    # per-head group norm, then gate and project
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yf = ((yf - mu) * torch.rsqrt(var + 64e-5)).reshape(B, S, H * hs)
    ln = p["ln_x"]
    yf = yf * whole(ln["scale"], 0).float() + whole(ln["bias"], 0).float()
    return split.out(yf.to(dt) * g, split.cut(p["w_o"], 0, t)), s_new


def channel_mix_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    D, Fd = cfg.d_model, cfg.d_ff
    b.param("mu_k", (D,), ("embed_w",), init="zeros")
    b.param("mu_r", (D,), ("embed_w",), init="zeros")
    b.param("w_k", (D, Fd), ("embed_w", "mlp_w"), fan_in=D)
    b.param("w_v", (Fd, D), ("mlp_w", "embed_w"),
            fan_in=Fd, scale=1.0 / math.sqrt(2 * cfg.num_layers))
    b.param("w_r", (D, D), ("embed_w", "qkv"), fan_in=D)


def channel_mix_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                      state: dict | None = None, split: Split | None = None
                      ) -> tuple[torch.Tensor, dict | None]:
    """Under a tensor ``split`` the key mix enters the slices (``w_k`` by
    columns, ``w_v`` by rows) and their float32 ``kv`` parts are summed;
    the gate ``sigmoid(xr w_r)``, which multiplies the summed ``kv``, runs
    whole on every rank (``w_r`` kept whole: ROADMAP P19)."""
    split = WHOLE if split is None else split
    dt = x.dtype
    xx = shift_tokens(x, None if state is None else state["x_prev"]) - x
    xk = x + xx * p["mu_k"].to(dt)
    xr = x + xx * p["mu_r"].to(dt)

    def part(t: int) -> torch.Tensor:
        k = torch.square(F.relu(split.enter(xk) @ split.cut(p["w_k"], 1, t).to(dt)))
        return split.out(k, split.cut(p["w_v"], 0, t))

    kv = split.sum(part).to(dt)
    out = torch.sigmoid(xr @ p["w_r"].to(dt)) * kv
    return out, None if state is None else {"x_prev": x[:, -1]}


def rwkv_block_init(b: ParamBuilder, cfg: ModelConfig) -> None:
    norm_init(b, "ln1", cfg.d_model, cfg.norm_kind)
    norm_init(b, "ln2", cfg.d_model, cfg.norm_kind)
    time_mix_init(b.sub("att"), cfg)
    channel_mix_init(b.sub("ffn"), cfg)


def rwkv_block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                     state: dict | None = None, plain: bool = False,
                     collector: Collector = NULL_COLLECTOR, split: Split | None = None
                     ) -> tuple[torch.Tensor, dict | None]:
    """One RWKV-6 layer; ln1/ln2 go through K1, a state-free recurrence
    through K5 (on each tensor slice's heads under a ``split``).  Returns
    ``(x, new state or None)``."""
    h = norm_apply(p["ln1"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    a, att_new = time_mix_apply(
        p["att"], cfg, h, state=None if state is None else state["att"],
        plain=plain, collector=collector, split=split)
    x = x + collector.tag("att_resid", a)
    h = norm_apply(p["ln2"], x, cfg.norm_kind, cfg.norm_eps, plain=plain)
    f, ffn_new = channel_mix_apply(
        p["ffn"], cfg, h, state=None if state is None else state["ffn"], split=split)
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
