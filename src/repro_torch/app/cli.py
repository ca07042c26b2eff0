"""`python -m repro_torch` — the port's CLI.

    python -m repro_torch train --arch qwen2-0.5b --seq-len 2048 --global-batch 8 --steps 8
    python -m repro_torch train --arch qwen2-0.5b --smoke --device cpu --steps 3
    python -m repro_torch serve --arch qwen2-0.5b --continuous
    python -m repro_torch serve --arch qwen2-0.5b --smoke --continuous --device cpu

``train`` is the counterpart of ``python -m repro train``: random weights
from ``--seed``, ``SyntheticTokens`` batches, AdamW, one line per step, with
the JAX CLI's flag names and defaults (sequence 128 smoke / 4096 full, global
batch 8 smoke / 256 full, warmup ``max(steps // 10, 5)``).  ``serve`` is
``python -m repro serve --continuous``: a Poisson workload
(``make_poisson_workload``) and MegaServe draining it.  Both run on the card
unless ``--device cpu`` is given.  Flags that select a later slice's path
are accepted and refused with ``NotImplementedError``'s message.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="MegatronApp repro, PyTorch/CUDA port.",
    )
    sub = ap.add_subparsers(dest="workload", required=True)
    t = sub.add_parser("train")
    t.add_argument("--arch", required=True)
    t.add_argument("--smoke", action="store_true")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    t.add_argument("--steps", type=int, default=100)
    t.add_argument("--global-batch", type=int, default=0,
                   help="0 = 8 smoke / 256 full")
    t.add_argument("--seq-len", type=int, default=0,
                   help="0 = 128 smoke / 4096 full")
    t.add_argument("--lr", type=float, default=3e-4)
    t.add_argument("--schedule", default="cosine",
                   choices=("cosine", "wsd", "constant"))
    t.add_argument("--warmup-steps", type=int, default=0,
                   help="0 = max(steps // 10, 5)")
    t.add_argument("--grad-accum", type=int, default=1)
    p = sub.add_parser("serve")
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--continuous", action="store_true",
                   help="MegaServe continuous batching (the only serving "
                        "path ported so far)")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--rate", type=float, default=100.0,
                   help="Poisson arrival rate, requests/s")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--num-blocks", type=int, default=0,
                   help="physical KV blocks (0 = size for zero preemption)")
    p.add_argument("--prompt-lens", default="16,32,64,128,256")
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--decode-path", default="auto",
                   choices=("auto", "paged", "gathered"))
    p.add_argument("--prefill-path", default="auto",
                   choices=("auto", "flash", "dense"))
    p.add_argument("--spec-decode", action="store_true")
    p.add_argument("--chunked-prefill", action="store_true")
    return ap


def run(argv: list[str]) -> dict:
    """Parse and run a workload; returns ``train``'s ``{"history"}`` or
    ``serve``'s ``{"metrics", "streams", "serve_config"}``."""
    args = build_parser().parse_args(argv)
    if args.workload == "train":
        return run_train(args)
    return run_serve(args)


def run_train(args: argparse.Namespace) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.optim import OptimizerConfig

    cfg = get_config(args.arch, smoke=args.smoke)
    seq = args.seq_len or (128 if args.smoke else 4096)
    batch = args.global_batch or (8 if args.smoke else 256)
    if batch % max(args.grad_accum, 1):
        raise ValueError(f"global batch {batch} not divisible by "
                         f"--grad-accum {args.grad_accum}")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)
    ocfg = OptimizerConfig(
        lr=args.lr, schedule=args.schedule,
        warmup_steps=args.warmup_steps or max(args.steps // 10, 5),
        total_steps=args.steps,
    )
    loop = LoopConfig(n_steps=args.steps, log_every=max(args.steps // 10, 1),
                      grad_accum=args.grad_accum, seed=args.seed)
    print(f"arch={cfg.name} device={args.device} seq_len={seq} "
          f"global_batch={batch} grad_accum={args.grad_accum} "
          f"steps={args.steps}", flush=True)
    _, history = train(cfg, ocfg, data, loop, device=args.device)
    for h in history:
        print(f"step {h['step']:>5}  loss {h['loss']:.4f}  lr {h['lr']:.2e}  "
              f"grad_norm {h['grad_norm']:.4f}  step_ms {1e3 * h['step_s']:.1f}")
    return {"history": history}


def run_serve(args: argparse.Namespace) -> dict:
    if not args.continuous:
        raise NotImplementedError(
            "static lockstep serving is not ported yet: it arrives with the "
            "static-runner slice (ROADMAP queue 1); pass --continuous")

    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.server import MegaServe, make_poisson_workload

    cfg = get_config(args.arch, smoke=args.smoke)
    params = lm.init(cfg, seed=args.seed, device=args.device)
    specs, prompts, serve_cfg = make_poisson_workload(
        cfg, n=args.requests, rate=args.rate,
        prompt_lens=tuple(int(x) for x in args.prompt_lens.split(",")),
        max_new_range=(max(1, args.max_new // 4), args.max_new),
        num_slots=args.slots, block_size=args.block_size,
        num_blocks=args.num_blocks, seed=args.seed,
    )
    serve_cfg = replace(
        serve_cfg, decode_path=args.decode_path,
        prefill_path=args.prefill_path, spec_decode=args.spec_decode,
        chunked_prefill=args.chunked_prefill,
    )
    srv = MegaServe(cfg, params, serve_cfg, device=args.device)
    del params  # the server holds its own compute-dtype copy
    for spec in specs:
        srv.submit(prompts[spec.rid], spec.max_new, arrival=spec.arrival)
    outs = srv.drain()
    met = srv.metrics()

    print(f"arch={cfg.name} continuous device={srv.device} "
          f"slots={serve_cfg.num_slots} "
          f"blocks={serve_cfg.num_blocks}x{serve_cfg.block_size} "
          f"requests={len(outs)} decode_path={srv.decode_path} "
          f"prefill_path={srv.prefill_path}")
    for k in ("generated_tokens", "wall_s", "tokens_per_s", "ttft_p50_s",
              "ttft_p99_s", "queue_wait_p50_s", "queue_wait_p99_s",
              "latency_p50_s", "latency_p99_s", "preemptions", "steps"):
        v = met[k]
        print(f"  {k:16s} {v:.4f}" if isinstance(v, float) else f"  {k:16s} {v}")
    for rid in list(outs)[:2]:
        print(f"  req {rid}: {outs[rid][:12]}...")
    config = {"num_slots": serve_cfg.num_slots,
              "block_size": serve_cfg.block_size,
              "num_blocks": serve_cfg.num_blocks}
    print(json.dumps({"serve_config": config}))
    return {"metrics": met, "streams": outs, "serve_config": config}


def main(argv: list[str] | None = None) -> None:
    try:
        run(sys.argv[1:] if argv is None else list(argv))
    except (ValueError, KeyError, NotImplementedError, RuntimeError) as e:
        # config guards (unknown arch, a later slice's path, no card) exit
        # with their message instead of a traceback
        msg = e.args[0] if e.args and isinstance(e.args[0], str) else str(e)
        raise SystemExit(msg) from e


if __name__ == "__main__":
    main()
