#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each of which fails the run (non-zero exit) on error:

1. device  — requires a CUDA card; prints its name and power limit;
2. build   — compiles the CUDA kernels from ``src/repro_torch`` with nvcc and
             prints ptxas' registers / shared memory / spills;
3. kernels — holds each kernel against its plain PyTorch version on the card:
             paged decode and prefill (K3, K4) at qwen2-0.5b widths (H=14,
             K=2, dh=64, block 16), RMSNorm forward and backward (K1, Triton)
             and flash attention forward and backward (K2) at the training
             path's shapes and at small ragged ones, all bfloat16; then times
             kernel, plain version and a library yardstick the port never
             calls (``scaled_dot_product_attention``, ``F.rms_norm``) at the
             main paths' shapes;
4. serve   — full-width qwen2-0.5b (24 layers, random weights from a seed)
             served by MegaServe on 32 Poisson requests; every decode tick and
             every prompt must launch each paged kernel once per layer and
             the RMSNorm kernel once per norm;
5. check   — replays finished streams teacher-forced through the kernel path
             and through the plain path on the card and compares the logits;
6. train   — full-width qwen2-0.5b trained 8 steps at seq 2048 x batch 8
             through ``repro_torch.train.loop.train``; launches per step must
             equal the counts worked out from the depth and full remat, every
             loss must be finite and the last below the first;
7. step    — one train step from one state and batch through the kernels and
             through the plain versions: loss, grad_norm and each layer's
             attention and norm gradient norms must agree;
8. summary — a ``{"kernels": [...]}`` line, then the last line
             ``{"ok": true, "device": {...}}``.

Needs the CUDA toolkit (nvcc) and PyTorch built for CUDA; imports no JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

H, K, DH, BS = 14, 2, 64, 16           # qwen2-0.5b attention widths
HBM_BYTES_PER_S = 3.35e12              # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12              # H100 SXM dense bf16 tensor cores
# kernel vs plain on bfloat16 N(0, 1) inputs: the plain version rounds the
# softmax probabilities to bfloat16 before the PV product (the kernels keep
# them float32, like the Pallas kernels) and both round the O(1) output to
# bfloat16 (ulp 2^-7 at 1..2); the prefill's in-kernel rope may differ from
# PyTorch's by a float32 ulp, flipping a bfloat16 rounding of q: a few ulps
KERNEL_TOL = 3e-2
# teacher-forced logits, kernel path vs plain path, 24 bfloat16 layers:
# differences of a few bfloat16 ulps per layer compound through the residual
# stream; logits of this random model are O(1) to 5 (ulp 2^-6 at 4)
LOGIT_TOL = 0.25
SERVE = dict(n=32, rate=40.0, prompt_lens=(128, 512, 2048),
             max_new_range=(16, 64), num_slots=8, block_size=BS, seed=0)

# the training path's shapes: qwen2-0.5b, seq 2048 x batch 8
TRAIN = dict(seq_len=2048, global_batch=8, steps=8)
NORM_ROWS, D_MODEL = TRAIN["seq_len"] * TRAIN["global_batch"], 896
# K1 on bfloat16: kernel and plain version each round one float32 result per
# element to bfloat16 once; float32 sums in another order can flip one
# rounding, one bfloat16 ulp of that element, at most 2^-7 of the largest
# |value| (8 significant bits): the error is taken relative to it.  dscale
# sums all rows in float32 in another order before its rounding: 1 % of its
# largest entry.
NORM_TOL = 2.0 ** -7
DSCALE_RTOL = 1e-2
# K2 on bfloat16, held row by row: a row of o, dq, dk or dv is one (batch,
# position, head) vector of D entries, and its error is max |kernel - plain|
# over the row divided by the row's largest |plain| entry.  Late causal rows
# average ~2000 values, so their |o| is ~0.03 where early rows are O(1): a
# limit on the whole tensor would be as large as a late row itself.  Both
# sides round each entry to bfloat16 once (one ulp is at most 2^-7 of the
# row's largest entry), and both round p to bfloat16 before the PV product,
# but the kernel's running max moves between kv tiles, so a few of those
# roundings differ (2^-9 of a p each, averaging out over a row).  Measured
# on the H100: at most 2^-7, one ulp, at every shape below.  The limit is
# four bfloat16 ulps of the row's largest entry; a kernel that drops one kv
# tile of 64 keys from rows past 1500 misses it by 24x (row error 0.75,
# plain versus plain with those keys masked, B=1 at the main shape).
FLASH_ROW_RTOL = 2.0 ** -5
# lse is float32 on both sides, m + log(l) with l summed over up to 2048
# keys in another order: a few float32 ulps of |lse| ~ 8 (ulp 9.5e-7, the
# largest difference measured on the H100).  One dropped key moves it by
# that key's probability, about 1/2048 = 4.9e-4.
LSE_TOL = 1e-5
# one train step, kernels vs plain versions, from one state and batch: the
# bfloat16 roundings that differ inside K1 and K2 (see above) move the loss
# (about 7.5) and the global gradient norm (about 91) by 6.2e-5 and 1.27e-4
# relative (measured on the H100); the global norm is dominated by the
# embedding and unembedding, so each layer's attention and norm gradients
# are also compared on their own (norm of the leaf's slice for that layer;
# at most 2.2e-3 relative, on the H100, for the k bias)
STEP_LOSS_TOL = 1e-3
STEP_GNORM_RTOL = 1e-3
STEP_LEAF_RTOL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


# ------------------------------------------------------------------ phase 3


def make_case(torch, gen, dev, *, S, Q, kv_lens, layers, M=None, qk_norm=False):
    """Random bf16 pools with distinct blocks per slot, tables, kv_len, q."""
    M = M or max(-(-k // BS) for k in kv_lens)
    nb = 1 + sum(-(-k // BS) for k in kv_lens)
    lead = (layers,) if layers else ()
    pools = [torch.randn(lead + (nb, BS, K, DH), generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(2)]
    tables = torch.zeros((S, M), dtype=torch.int32)
    nxt = 1
    for s, kvl in enumerate(kv_lens):
        n = -(-kvl // BS)
        tables[s, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n
    q = torch.randn((S, Q, H, DH), generator=gen, device=dev).to(torch.bfloat16)
    qn = torch.randn((DH,), generator=gen, device=dev) if qk_norm else None
    return dict(q=q, k=pools[0], v=pools[1], tables=tables.to(dev),
                kv_len=torch.tensor(kv_lens, dtype=torch.int32, device=dev),
                q_norm=qn)


def check_kernels(torch, dev) -> dict:
    from repro_torch.kernels.paged_attention import (
        paged_attention_plain, paged_decode_kernel, paged_prefill_kernel,
        paged_prefill_plain_from_raw,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    scale = DH ** -0.5
    worst = {"paged_decode": 0.0, "paged_prefill": 0.0}

    def decode(c, layer, window=None):
        kw = dict(scale=scale, window=window, layer=layer)
        o = paged_decode_kernel(c["q"], c["k"], c["v"], c["tables"], c["kv_len"], **kw)
        torch.cuda.synchronize()
        ref = paged_attention_plain(c["q"], c["k"], c["v"], c["tables"], c["kv_len"], **kw)
        return (o.float() - ref.float()).abs().max().item()

    def prefill(c, layer, q_start, window=None):
        Q = c["q"].shape[1]
        positions = (c["kv_len"].long()[:, None] - Q
                     + torch.arange(Q, device=dev)[None, :])
        kw = dict(scale=scale, window=window, layer=layer, q_norm=c["q_norm"],
                  rope_theta=1e6)
        o = paged_prefill_kernel(c["q"], c["k"], c["v"], c["tables"], c["kv_len"], **kw)
        torch.cuda.synchronize()
        ref = paged_prefill_plain_from_raw(
            c["q"], c["k"], c["v"], c["tables"], c["kv_len"],
            positions=positions, q_start=q_start, **kw)
        return (o.float() - ref.float()).abs().max().item()

    ragged = [4096, 1, 17, 300, 2048, 1000, 63, 3333]
    cases = [
        ("paged_decode", "Q=1 ragged kv_len<=4096, 5-D pool",
         lambda: decode(make_case(torch, gen, dev, S=8, Q=1, kv_lens=ragged,
                                  layers=3), 2)),
        ("paged_decode", "Q=1 ragged, 4-D pool",
         lambda: decode(make_case(torch, gen, dev, S=8, Q=1, kv_lens=ragged,
                                  layers=0), None)),
        ("paged_decode", "Q=5 ragged, 5-D pool",
         lambda: decode(make_case(torch, gen, dev, S=8, Q=5,
                                  kv_lens=[5, 40, 4096, 777, 16, 33, 2000, 9],
                                  layers=2), 1)),
        ("paged_decode", "Q=5 ragged, window 256, 4-D pool",
         lambda: decode(make_case(torch, gen, dev, S=4, Q=5,
                                  kv_lens=[3000, 300, 64, 1025], layers=0),
                        None, window=256)),
        ("paged_prefill", "P=128 q_start=0, 5-D pool",
         lambda: prefill(make_case(torch, gen, dev, S=1, Q=128, kv_lens=[128],
                                   layers=2), 1, 0)),
        ("paged_prefill", "P=2048 q_start=0, 5-D pool",
         lambda: prefill(make_case(torch, gen, dev, S=1, Q=2048,
                                   kv_lens=[2048], layers=2), 0, 0)),
        ("paged_prefill", "Q=128 mid-sequence start (kv_len 828), 4-D pool",
         lambda: prefill(make_case(torch, gen, dev, S=1, Q=128, kv_lens=[828],
                                   layers=0), None, None)),
        ("paged_prefill", "P=512 window 128, 4-D pool",
         lambda: prefill(make_case(torch, gen, dev, S=1, Q=512, kv_lens=[512],
                                   layers=0), None, 0, window=128)),
        ("paged_prefill", "P=128 random q_norm, 2 slots, 5-D pool",
         lambda: prefill(make_case(torch, gen, dev, S=2, Q=128,
                                   kv_lens=[128, 400], layers=2, qk_norm=True),
                         1, None)),
    ]
    for name, what, run in cases:
        err = run()
        ok = err <= KERNEL_TOL
        log(f"[kernels] {name:13s} {what:50s} max_err={err:.3e} "
            f"tol={KERNEL_TOL:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: {what}")
        worst[name] = max(worst[name], err)
    return worst


def time_kernels(torch, dev, worst: dict) -> dict:
    """Kernel, plain and library times at the main path's shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import (
        paged_attention_plain, paged_decode_kernel, paged_prefill_kernel,
        paged_prefill_plain_from_raw,
    )

    gen = torch.Generator(device=dev).manual_seed(1)
    scale = DH ** -0.5
    out = {}

    # decode: one tick of the serve phase's shape — 8 slots at kv_len of
    # prompts 128/512/2048 plus generated tokens, the 24-layer pool, table
    # width 132 (the workload's worst request); successive launches walk
    # successive layers so the 24-layer working set exceeds the 50 MB L2
    kv_lens = [2112, 544, 160, 2080, 530, 140, 2100, 600]
    c = make_case(torch, gen, dev, S=8, Q=1, kv_lens=kv_lens, layers=24, M=132)
    layer = iter(range(10 ** 9))
    args = (c["q"], c["k"], c["v"], c["tables"], c["kv_len"])
    ms = cuda_ms(lambda: paged_decode_kernel(*args, scale=scale, layer=next(layer) % 24), 96)
    plain = cuda_ms(lambda: paged_attention_plain(*args, scale=scale, layer=next(layer) % 24), 24)
    # library yardstick: SDPA over a dense view gathered beforehand (gather
    # not timed), kv heads repeated to the query heads, padding masked
    T = max(kv_lens)
    kd = torch.zeros((8, H, T, DH), dtype=torch.bfloat16, device=dev)
    vd = torch.zeros_like(kd)
    for s, n in enumerate(kv_lens):
        blocks = c["tables"][s, : -(-n // BS)].long()
        for src, dst in ((c["k"][0], kd), (c["v"][0], vd)):
            dense = src[blocks].reshape(-1, K, DH)[:n]           # [n, K, dh]
            dst[s, :, :n] = dense.permute(1, 0, 2).repeat_interleave(H // K, 0)
    mask = (torch.arange(T, device=dev)[None, :]
            < c["kv_len"][:, None]).reshape(8, 1, 1, T)
    qd = c["q"].permute(0, 2, 1, 3)                               # [S, H, 1, dh]
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=scale), 96)
    live = sum(kv_lens)
    nbytes = 2 * (2 * 8 * H * DH) + 2 * 2 * live * K * DH + 4 * (8 * 132 + 8)
    flops = 4 * live * H * DH
    b_ms, b_by = bound(flops, nbytes)
    out["paged_decode"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=b_ms, bound_by=b_by,
                               max_abs_err=worst["paged_decode"])
    log(f"[timing] paged_decode  S=8 Q=1 kv_len={kv_lens} M=132 24-layer pool: "
        f"kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
        f"bound_ms={b_ms:.6f} ({b_by})")

    # prefill: the workload's longest prompt, P = 2048 from position 0
    P = 2048
    c = make_case(torch, gen, dev, S=1, Q=P, kv_lens=[P], layers=24)
    args = (c["q"], c["k"], c["v"], c["tables"], c["kv_len"])
    positions = torch.arange(P, device=dev)[None, :]
    ms = cuda_ms(lambda: paged_prefill_kernel(*args, scale=scale, layer=next(layer) % 24,
                                              rope_theta=1e6), 24)
    plain = cuda_ms(lambda: paged_prefill_plain_from_raw(
        *args, positions=positions, scale=scale, layer=next(layer) % 24,
        rope_theta=1e6, q_start=0), 6)
    kd = c["k"][0, 1:1 + P // BS].reshape(P, K, DH).permute(1, 0, 2)
    kd = kd.repeat_interleave(H // K, 0)[None].contiguous()
    vd = c["v"][0, 1:1 + P // BS].reshape(P, K, DH).permute(1, 0, 2)
    vd = vd.repeat_interleave(H // K, 0)[None].contiguous()
    qd = c["q"].permute(0, 2, 1, 3).contiguous()
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, is_causal=True, scale=scale), 24)
    nbytes = 2 * (2 * P * H * DH) + 2 * 2 * P * K * DH + 4 * (P // BS + 1)
    flops = 4 * (P * (P + 1) // 2) * H * DH
    b_ms, b_by = bound(flops, nbytes)
    out["paged_prefill"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                bound_ms=b_ms, bound_by=b_by,
                                max_abs_err=worst["paged_prefill"])
    log(f"[timing] paged_prefill P={P} q_start=0 24-layer pool: kernel_ms={ms:.4f} "
        f"plain_ms={plain:.4f} library_ms={lib:.4f} bound_ms={b_ms:.6f} ({b_by})")
    return out


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _row_err(a, ref) -> float:
    """Largest over rows (the last axis) of max |a - ref| / max |ref|.  A row
    whose largest entry is below 1 % of the median row's is divided by that
    1 % instead: such rows are sums that cancel to about zero (dq of query
    row 0, which sees one key, is exactly zero in exact arithmetic), and
    there both sides hold float32 rounding noise of ~1e-8."""
    d = (a.float() - ref.float()).abs().amax(-1)
    m = ref.float().abs().amax(-1)
    return (d / m.clamp_min(1e-2 * m.median()).clamp_min(1e-30)).max().item()


def _flash_inputs(torch, gen, dev, B, S, T, H_, K_, D):
    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    return r(B, S, H_, D), r(B, T, K_, D), r(B, T, K_, D), r(B, S, H_, D)


def check_training_kernels(torch, dev) -> dict:
    """K1 and K2 against their plain versions; returns the worst errors."""
    from repro_torch.kernels.flash_attention import (
        flash_bwd_kernel, flash_bwd_plain, flash_fwd_kernel, flash_fwd_plain)
    from repro_torch.kernels.rmsnorm import (
        rmsnorm_bwd_kernel, rmsnorm_bwd_plain, rmsnorm_fwd_kernel, rmsnorm_plain)

    gen = torch.Generator(device=dev).manual_seed(2)
    # K1: the case nearest its tolerance, (max |error|, the absolute
    # tolerance that case was held to); K2: the largest |error| and the
    # largest row error over the cases, held to FLASH_ROW_RTOL
    worst = dict.fromkeys(("rmsnorm_fwd", "rmsnorm_bwd"), (0.0, 1.0))
    worst.update(dict.fromkeys(("flash_fwd", "flash_bwd"), (0.0, 0.0)))

    def record(name, err, tol):
        if err / tol >= worst[name][0] / worst[name][1]:
            worst[name] = (err, tol)

    def record_flash(name, abs_err, row_err):
        worst[name] = tuple(map(max, worst[name], (abs_err, row_err)))

    def norm(rows, D, sdtype, what):
        x = torch.randn((rows, D), generator=gen, device=dev).bfloat16()
        sc = (1 + 0.3 * torch.randn((D,), generator=gen, device=dev)).to(sdtype)
        dy = torch.randn((rows, D), generator=gen, device=dev).bfloat16()
        y, rstd = rmsnorm_fwd_kernel(x, sc, 1e-6)
        dx, ds = rmsnorm_bwd_kernel(x, sc, rstd, dy)
        torch.cuda.synchronize()
        ry = rmsnorm_plain(x, sc, 1e-6)
        a_y, m_y = _err(y, ry), ry.float().abs().max().item()
        rdx, rds = rmsnorm_bwd_plain(x, sc, dy, 1e-6)
        a_dx, m_dx = _err(dx, rdx), rdx.float().abs().max().item()
        e_y, e_dx = a_y / m_y, a_dx / m_dx
        e_ds = _err(ds, rds) / rds.float().abs().max().item()
        ok = e_y <= NORM_TOL and e_dx <= NORM_TOL and e_ds <= DSCALE_RTOL
        log(f"[kernels] rmsnorm       {what:50s} y_rel_err={e_y:.3e} dx_rel_err={e_dx:.3e} "
            f"dscale_rel_err={e_ds:.3e} tol={NORM_TOL:.2e}/{DSCALE_RTOL:.0e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"rmsnorm disagrees with its plain version: {what}")
        record("rmsnorm_fwd", a_y, NORM_TOL * m_y)
        record("rmsnorm_bwd", a_dx, NORM_TOL * m_dx)

    def flash(B, S, T, H_, K_, D, causal, window, what):
        q, k, v, do = _flash_inputs(torch, gen, dev, B, S, T, H_, K_, D)
        kw = dict(scale=D ** -0.5, causal=causal, window=window)
        o, lse = flash_fwd_kernel(q, k, v, **kw)
        grads = flash_bwd_kernel(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        ro, rlse = flash_fwd_plain(q, k, v, **kw)
        a_o, r_o, e_lse = _err(o, ro), _row_err(o, ro), _err(lse, rlse)
        refs = flash_bwd_plain(q, k, v, o, lse, do, **kw)
        a_g = max(_err(g, r) for g, r in zip(grads, refs))
        r_g = {n: _row_err(g, r) for n, g, r in zip(("dq", "dk", "dv"), grads, refs)}
        del ro, rlse, refs
        ok = r_o <= FLASH_ROW_RTOL and e_lse <= LSE_TOL and max(r_g.values()) <= FLASH_ROW_RTOL
        log(f"[kernels] flash         {what:50s} o_row_err={r_o:.3e} lse_err={e_lse:.3e} "
            + " ".join(f"{n}_row_err={e:.3e}" for n, e in r_g.items())
            + f" o_abs_err={a_o:.3e} grad_abs_err={a_g:.3e} "
            f"tol={FLASH_ROW_RTOL:.2e}/{LSE_TOL:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash attention disagrees with its plain version: {what}")
        record_flash("flash_fwd", a_o, r_o)
        record_flash("flash_bwd", a_g, max(r_g.values()))

    norm(NORM_ROWS, D_MODEL, torch.bfloat16, f"[{NORM_ROWS}, {D_MODEL}] bf16, bf16 scale")
    norm(8 * 2048 * 40, 128, torch.bfloat16, "[B*S*H=655360, 128] qwen3 qk_norm shape")
    norm(16383, D_MODEL, torch.float32, f"[16383, {D_MODEL}] odd rows, f32 scale")
    flash(8, 2048, 2048, H, K, DH, True, None, "B=8 S=T=2048 H=14 K=2 dh=64 causal")
    flash(2, 300, 300, H, K, DH, True, 100, "B=2 S=T=300 window 100")
    flash(2, 200, 333, 4, 2, 128, False, None, "B=2 S=200 T=333 bidirectional dh=128")
    flash(1, 77, 77, 8, 8, 64, True, None, "B=1 S=T=77 MHA causal")
    return worst


def time_training_kernels(torch, dev, worst: dict) -> dict:
    """K1 and K2: kernel, plain and library times at the train path's shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_bwd_kernel, flash_bwd_plain, flash_fwd_kernel, flash_fwd_plain)
    from repro_torch.kernels.rmsnorm import (
        rmsnorm_bwd_kernel, rmsnorm_bwd_plain, rmsnorm_fwd_kernel, rmsnorm_plain)

    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    N, D = NORM_ROWS, D_MODEL
    x = torch.randn((N, D), generator=gen, device=dev).bfloat16()
    sc = (1 + 0.3 * torch.randn((D,), generator=gen, device=dev)).bfloat16()
    dy = torch.randn((N, D), generator=gen, device=dev).bfloat16()
    _, rstd = rmsnorm_fwd_kernel(x, sc, 1e-6)
    xl = x.clone().requires_grad_(True)
    sl = sc.clone().requires_grad_(True)

    def lib_norm_fb():
        y = F.rms_norm(xl, (D,), weight=sl, eps=1e-6)
        torch.autograd.grad(y, (xl, sl), dy)

    rows = {
        "rmsnorm_fwd": (lambda: rmsnorm_fwd_kernel(x, sc, 1e-6),
                        lambda: rmsnorm_plain(x, sc, 1e-6),
                        lambda: F.rms_norm(x, (D,), weight=sc, eps=1e-6),
                        bound(0, 2 * 2 * N * D + 4 * N + 2 * D)),
        "rmsnorm_bwd": (lambda: rmsnorm_bwd_kernel(x, sc, rstd, dy),
                        lambda: rmsnorm_bwd_plain(x, sc, dy, 1e-6),
                        lib_norm_fb,
                        bound(0, 3 * 2 * N * D + 4 * N + 2 * 2 * D)),
    }
    for name, (kern, plain, lib, (b_ms, b_by)) in rows.items():
        out[name] = dict(ms=cuda_ms(kern, 50), plain_ms=cuda_ms(plain, 20),
                         library_ms=cuda_ms(lib, 50), bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=worst[name][0], tolerance=worst[name][1])

    B, S = TRAIN["global_batch"], TRAIN["seq_len"]
    q, k, v, do = _flash_inputs(torch, gen, dev, B, S, S, H, K, DH)
    kw = dict(scale=DH ** -0.5, causal=True, window=None)
    o, lse = flash_fwd_kernel(q, k, v, **kw)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              scale=DH ** -0.5, enable_gqa=True)

    def sdpa_fb():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    pairs = B * H * S * (S + 1) // 2
    io_bytes = 2 * (2 * B * S * H * DH + 2 * B * S * K * DH)
    rows = {
        "flash_fwd": (lambda: flash_fwd_kernel(q, k, v, **kw),
                      lambda: flash_fwd_plain(q, k, v, **kw), sdpa,
                      bound(4 * pairs * DH, io_bytes + 4 * B * H * S)),
        "flash_bwd": (lambda: flash_bwd_kernel(q, k, v, o, lse, do, **kw),
                      lambda: flash_bwd_plain(q, k, v, o, lse, do, **kw), sdpa_fb,
                      bound(10 * pairs * DH, 2 * io_bytes + 4 * B * H * S)),
    }
    for name, (kern, plain, lib, (b_ms, b_by)) in rows.items():
        out[name] = dict(ms=cuda_ms(kern, 10), plain_ms=cuda_ms(plain, 3, warmup=1),
                         library_ms=cuda_ms(lib, 20), bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=worst[name][0], max_row_err=worst[name][1],
                         tolerance=FLASH_ROW_RTOL)
    for name, t in out.items():
        what = ("[16384, 896] bf16" if name.startswith("rms")
                else "B=8 S=T=2048 H=14 K=2 dh=64 causal")
        lib = ("F.rms_norm" if name.startswith("rms") else "SDPA") + (
            " fwd+bwd" if name.endswith("bwd") else "")
        log(f"[timing] {name:13s} {what}: kernel_ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} ({lib}) "
            f"bound_ms={t['bound_ms']:.6f} ({t['bound_by']})")
    return out


# ---------------------------------------------------------------- phase 4-5


def serve(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import rmsnorm
    from repro_torch.kernels.paged_attention import launches, reset_launches
    from repro_torch.models import lm
    from repro_torch.serve.server import MegaServe, make_poisson_workload

    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    specs, prompts, scfg = make_poisson_workload(cfg, **SERVE)
    srv = MegaServe(cfg, params, scfg, device="cuda")
    del params
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} vocab={cfg.padded_vocab}; "
        f"{scfg.num_slots} slots, {scfg.num_blocks} blocks x {scfg.block_size}, "
        f"table width {scfg.max_blocks_per_slot}; set-up "
        f"{time.perf_counter() - t0:.2f} s")
    # warm-up (cuBLAS handles, allocator), then time the workload afresh
    for n in sorted({s.prompt_len for s in specs}):
        srv.submit(prompts[0][:1] * n, 2, arrival=0.0)
    srv.drain()
    srv.reset()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    rmsnorm.reset_launches()
    for s in specs:
        srv.submit(prompts[s.rid], s.max_new, arrival=s.arrival, rid=s.rid)
    streams = srv.drain()
    torch.cuda.synchronize()
    counts = {**launches, **rmsnorm.launches}
    met = srv.metrics()

    events = srv.trace_events()
    ticks = [e.dur for e in events if e.name == "decode"]
    n_prefill = sum(e.name == "prefill" for e in events)
    L = cfg.num_layers
    log(f"[serve] finished={met['finished']}/{len(specs)} "
        f"tokens={met['generated_tokens']} tokens_per_s={met['tokens_per_s']:.2f} "
        f"ttft_p50_s={met['ttft_p50_s']:.4f} ttft_p99_s={met['ttft_p99_s']:.4f} "
        f"queue_wait_p50_s={met['queue_wait_p50_s']:.4f} "
        f"decode_tick_median_ms={1e3 * statistics.median(ticks):.3f} "
        f"ticks={len(ticks)} prefills={n_prefill} "
        f"preemptions={met['preemptions']} wall_s={met['wall_s']:.3f} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    log(f"[serve] launches {counts} expected decode {len(ticks)}x{L}="
        f"{len(ticks) * L} prefill {n_prefill}x{L}={n_prefill * L}")
    if counts["paged_decode"] != len(ticks) * L or counts["paged_decode"] == 0:
        raise AssertionError("decode kernel launches != decode ticks x layers")
    if counts["paged_prefill"] != n_prefill * L or counts["paged_prefill"] == 0:
        raise AssertionError("prefill kernel launches != prompts x layers")
    # every forward runs two norms a layer and the final norm (qwen2 has no
    # qk_norm), and nothing takes a gradient
    want_norm = (2 * L + 1) * (len(ticks) + n_prefill)
    log(f"[serve] rmsnorm launches fwd {counts['rmsnorm_fwd']} bwd "
        f"{counts['rmsnorm_bwd']} expected fwd (2x{L}+1)x{len(ticks) + n_prefill}"
        f"={want_norm} bwd 0")
    if counts["rmsnorm_fwd"] != want_norm or counts["rmsnorm_bwd"] != 0:
        raise AssertionError("rmsnorm launches != (2 x layers + 1) x forwards")
    if met["finished"] != len(specs):
        raise AssertionError("not every request finished")
    for s in specs:
        toks = streams[s.rid]
        if len(toks) != s.max_new or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {s.rid}: bad stream {toks[:8]}...")
    return cfg, srv, specs, prompts, streams, counts


def replay(torch, cfg, params, prompt, forced, *, plain):
    """Teacher-forced logits ``[len(forced), V]``: prefill ``prompt``, then
    decode ``forced[:-1]`` one token at a time, in a pool of its own."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import make_flash_prefill_step, make_paged_decode_step
    from repro_torch.serve.paged_cache import blocks_for

    dev = torch.device("cuda")
    n_blk = blocks_for(len(prompt) + len(forced), BS)
    pool = lm.init_pool(cfg, n_blk + 1, BS, dev)
    table = torch.arange(1, n_blk + 1, dtype=torch.int32, device=dev)[None]
    prefill = make_flash_prefill_step(cfg, block_size=BS, plain=plain)
    decode = make_paged_decode_step(cfg, block_size=BS, plain=plain)
    p_blk = blocks_for(len(prompt), BS)
    toks = torch.tensor([prompt + [0] * (p_blk * BS - len(prompt))], device=dev)
    out = [prefill(params, pool, table[:, :p_blk].contiguous(), toks, len(prompt))]
    for i, tok in enumerate(forced[:-1]):
        pos = torch.tensor([len(prompt) + i], dtype=torch.int32, device=dev)
        out.append(decode(params, pool, table, torch.tensor([tok], device=dev), pos)[0])
    return torch.stack(out).float()


def teacher_forced(torch, cfg, srv, specs, prompts, streams) -> None:
    from repro_torch.kernels.paged_attention import launches

    picked = {}
    for s in specs:  # one finished stream per prompt length
        picked.setdefault(s.prompt_len, s)
    before = dict(launches)
    for plen, s in sorted(picked.items()):
        forced = streams[s.rid]
        lk = replay(torch, cfg, srv.params, prompts[s.rid], forced, plain=False)
        lp = replay(torch, cfg, srv.params, prompts[s.rid], forced, plain=True)
        V = cfg.vocab_size
        err = (lk[:, :V] - lp[:, :V]).abs().max().item()
        idx = torch.tensor(forced, device=lp.device)[:, None]
        gap = (lp[:, :V].max(-1).values - lp.gather(1, idx)[:, 0]).max().item()
        agree = (lk[:, :V].argmax(-1) == lp[:, :V].argmax(-1)).float().mean().item()
        ok = err <= LOGIT_TOL and gap <= LOGIT_TOL and torch.isfinite(lk).all()
        log(f"[check] rid={s.rid} prompt={plen} steps={len(forced)} "
            f"max_logit_err={err:.4f} max_gap_to_plain_max={gap:.4f} "
            f"argmax_agree={agree:.3f} tol={LOGIT_TOL} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"teacher-forced check failed for rid {s.rid}")
    if launches == before:
        raise AssertionError("the kernel-path replay launched no kernel")


# ---------------------------------------------------------------- phase 6-7


def train_phase(torch, dev):
    """Full-width qwen2-0.5b, 8 steps at seq 2048 x batch 8 through the loop."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.models.model import count_params
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.optim import OptimizerConfig
    from repro_torch.train.train_step import init_train_state

    cfg = get_config("qwen2-0.5b").replace(remat="full")
    steps = TRAIN["steps"]
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
                      global_batch=TRAIN["global_batch"], seed=0)
    # the CLI's defaults: lr 3e-4, cosine, warmup max(steps // 10, 5)
    ocfg = OptimizerConfig(lr=3e-4, schedule="cosine",
                           warmup_steps=max(steps // 10, 5), total_steps=steps)
    state = init_train_state(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"[train] {cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} vocab={cfg.padded_vocab} "
        f"params={count_params(state.master)} remat={cfg.remat} "
        f"seq={data.seq_len} batch={data.global_batch}")
    torch.cuda.reset_peak_memory_stats()
    flash_attention.reset_launches()
    rmsnorm.reset_launches()
    state, history = train(cfg, ocfg, data, LoopConfig(n_steps=steps, seed=0),
                           state=state, device=dev)
    torch.cuda.synchronize()
    counts = {**flash_attention.launches, **rmsnorm.launches}
    peak = torch.cuda.max_memory_allocated()
    for h in history:
        log(f"[train] step {h['step']} loss={h['loss']:.4f} lr={h['lr']:.3e} "
            f"grad_norm={h['grad_norm']:.4f} step_ms={1e3 * h['step_s']:.1f} "
            f"tokens_per_s={h['tokens_per_s']:.1f}")
    # per step, with full remat every layer's forward runs twice (once in the
    # forward, once recomputed in the backward) and its backward once; each
    # layer has two RMSNorms (ln1, ln2; qwen2 has no qk_norm) and one
    # attention above attn_kv_chunk (2048 > 1024: the flash branch), and the
    # final norm runs once each way:
    #   flash_fwd 2L = 48, flash_bwd L = 24, rmsnorm_fwd 2*2L + 1 = 97,
    #   rmsnorm_bwd 2L + 1 = 49
    L = cfg.num_layers
    per_step = {"flash_fwd": 2 * L, "flash_bwd": L, "rmsnorm_fwd": 4 * L + 1,
                "rmsnorm_bwd": 2 * L + 1}
    steady = sorted(h["step_s"] for h in history[1:])
    step_s = steady[len(steady) // 2]
    tokens = data.seq_len * data.global_batch
    log(f"[train] launches per step {dict((k, v / steps) for k, v in counts.items())} "
        f"expected {per_step}")
    log(f"[train] median step (steps 2-{steps}) {1e3 * step_s:.1f} ms, "
        f"{tokens / step_s:.1f} tokens/s; first step {1e3 * history[0]['step_s']:.1f} ms; "
        f"max_memory_allocated={peak}")
    if any(counts[k] != steps * n for k, n in per_step.items()):
        raise AssertionError(f"train launches {counts} != {steps} x {per_step}")
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: {losses}")
    return cfg, ocfg, data, state, counts, dict(step_s=step_s, tokens_per_s=tokens / step_s,
                                               peak=peak)


def one_step_check(torch, cfg, ocfg, data, state) -> None:
    """One step from one state and batch, kernels vs plain versions: loss,
    global gradient norm, and per layer the gradient norm of every attention
    and norm leaf (plus the final norm's)."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.train.optim import leaves
    from repro_torch.train.train_step import make_train_step

    def leaf_norms(grads):
        # layer-stacked leaves carry the layer on axis 0: one norm per layer
        norms.update({".".join(path): (g.float().flatten(1).norm(dim=1)
                                       if path[0].startswith("seg") else g.float().norm())
                      for path, g in leaves(grads)
                      if "attn" in path or path[-1] == "scale"})
        return grads

    batch = SyntheticTokens(data).batch_at(TRAIN["steps"])
    res = {}
    for plain in (False, True):
        norms: dict = {}
        _, m = make_train_step(cfg, ocfg, plain=plain, grad_transform=leaf_norms)(
            state, batch)
        res[plain] = (m["loss"].item(), m["grad_norm"].item(), norms)
        del m
        torch.cuda.empty_cache()
    (lk, gk, nk), (lp, gp, np_) = res[False], res[True]
    d_loss, d_gn = abs(lk - lp), abs(gk - gp) / gp
    d_leaf = {name: ((nk[name] - np_[name]).abs() / np_[name]).max().item()
              for name in np_}
    ok = (d_loss <= STEP_LOSS_TOL and d_gn <= STEP_GNORM_RTOL
          and max(d_leaf.values()) <= STEP_LEAF_RTOL and math.isfinite(lk))
    log(f"[step] kernels loss={lk:.5f} grad_norm={gk:.5f}; plain loss={lp:.5f} "
        f"grad_norm={gp:.5f}; |dloss|={d_loss:.2e} (tol {STEP_LOSS_TOL}) "
        f"rel dgrad_norm={d_gn:.2e} (tol {STEP_GNORM_RTOL})")
    log(f"[step] per-layer leaf gradient norms, largest relative difference: "
        + " ".join(f"{n}={e:.2e}" for n, e in sorted(d_leaf.items()))
        + f" (tol {STEP_LEAF_RTOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("one train step through the kernels disagrees with "
                             "the plain versions")


# -------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import shared_memory_bytes as flash_smem
    from repro_torch.kernels.paged_attention.ops import shared_memory_bytes

    t_start = time.perf_counter()
    dev = resolve_device("cuda")  # also turns off TF32 / reduced-precision bf16 sums
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build()
    log(f"[build] nvcc {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name):
            log(f"[build] {name}: {line}")
        if name.startswith("paged"):
            smem = shared_memory_bytes(name, H=H, K=K, dh=DH, bs=BS)
        else:
            smem = flash_smem(name, DH)
        log(f"[build] {name}: {smem} bytes of dynamic shared memory per block "
            f"at H={H} K={K} dh={DH}" + (f" bs={BS}" if name.startswith("paged") else ""))

    worst = check_kernels(torch, dev)
    worst.update(check_training_kernels(torch, dev))
    timings = time_kernels(torch, dev, worst)
    timings.update(time_training_kernels(torch, dev, worst))
    torch.cuda.empty_cache()
    cfg, srv, specs, prompts, streams, counts = serve(torch, dev)
    teacher_forced(torch, cfg, srv, specs, prompts, streams)
    del srv
    torch.cuda.empty_cache()
    tcfg, ocfg, data, state, train_counts, _ = train_phase(torch, dev)
    one_step_check(torch, tcfg, ocfg, data, state)
    del state

    # launches: the paged kernels' from the serve phase, K1's and K2's from
    # the train phase (K1's serve-phase count is checked in the serve phase);
    # K1's tolerance: the absolute bound of its case nearest it; K2's: the
    # row-relative limit its ``max_row_err`` is held to
    counts.update(train_counts)
    flash_src = "src/repro/kernels/flash_attention/kernel.py:86"
    norm_src = "src/repro/kernels/rmsnorm/kernel.py:26"
    norm_path = REPO / "src/repro_torch/kernels/rmsnorm/rmsnorm_triton.py"
    rows = [
        ("paged_decode", "cuda", _build.SOURCES["paged_decode"],
         "src/repro/kernels/paged_attention/kernel.py:139", KERNEL_TOL),
        ("paged_prefill", "cuda", _build.SOURCES["paged_prefill"],
         "src/repro/kernels/paged_attention/prefill_kernel.py:176", KERNEL_TOL),
        ("rmsnorm_fwd", "triton", norm_path, norm_src, None),
        ("rmsnorm_bwd", "triton", norm_path, norm_src, None),
        ("flash_fwd", "cuda", _build.SOURCES["flash_fwd"], flash_src, None),
        ("flash_bwd", "cuda", _build.SOURCES["flash_bwd"], flash_src, None),
    ]
    kernels = []
    for name, route, path, replaces, tol in rows:
        t = timings[name]
        kernels.append({
            "name": name, "route": route,
            "source": str(path.relative_to(REPO)), "replaces": replaces,
            "launches": counts[name], "max_abs_err": t["max_abs_err"],
            **({"max_row_err": t["max_row_err"]} if "max_row_err" in t else {}),
            "tolerance": t.get("tolerance", tol), "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
