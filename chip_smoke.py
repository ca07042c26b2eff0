#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each of which fails the run (non-zero exit) on error:

1. device  — requires a CUDA card; prints its name and power limit;
2. build   — compiles the CUDA kernels from ``src/repro_torch`` with nvcc and
             prints ptxas' registers / shared memory / spills;
3. kernels — holds each kernel against its plain PyTorch version on the card
             at qwen2-0.5b widths (H=14, K=2, dh=64, block 16, bfloat16), then
             times kernel, plain version and a library yardstick
             (``scaled_dot_product_attention`` over a gathered dense view,
             which the port never calls) at the main path's shapes;
4. serve   — full-width qwen2-0.5b (24 layers, random weights from a seed)
             served by MegaServe on 32 Poisson requests; every decode tick and
             every prompt must launch each kernel once per layer;
5. check   — replays finished streams teacher-forced through the kernel path
             and through the plain path on the card and compares the logits;
6. summary — a ``{"kernels": [...]}`` line, then the last line
             ``{"ok": true, "device": {...}}``.

Needs the CUDA toolkit (nvcc) and PyTorch built for CUDA; imports no JAX.
"""

from __future__ import annotations

import json
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


# ---------------------------------------------------------------- phase 4-5


def serve(torch, dev):
    from repro_torch.configs import get_config
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
    for s in specs:
        srv.submit(prompts[s.rid], s.max_new, arrival=s.arrival, rid=s.rid)
    streams = srv.drain()
    torch.cuda.synchronize()
    counts = dict(launches)
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


# -------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
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
        smem = shared_memory_bytes(name, H=H, K=K, dh=DH, bs=BS)
        log(f"[build] {name}: {smem} bytes of dynamic shared memory per block "
            f"at H={H} K={K} dh={DH} bs={BS}")

    worst = check_kernels(torch, dev)
    timings = time_kernels(torch, dev, worst)
    cfg, srv, specs, prompts, streams, counts = serve(torch, dev)
    teacher_forced(torch, cfg, srv, specs, prompts, streams)

    replaces = {
        "paged_decode": "src/repro/kernels/paged_attention/kernel.py:139",
        "paged_prefill": "src/repro/kernels/paged_attention/prefill_kernel.py:176",
    }
    kernels = []
    for name, path in _build.SOURCES.items():
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": str(path.relative_to(REPO)), "replaces": replaces[name],
            "launches": counts[name], "max_abs_err": t["max_abs_err"],
            "tolerance": KERNEL_TOL, "ms": t["ms"], "plain_ms": t["plain_ms"],
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
