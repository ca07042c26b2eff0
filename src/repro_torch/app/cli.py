"""`python -m repro_torch` — the port's CLI, counterpart of ``python -m repro``.

    python -m repro_torch train --arch qwen2-0.5b --seq-len 2048 --global-batch 8 --steps 8
    python -m repro_torch train --arch qwen2-0.5b --smoke --device cpu --steps 3
    python -m repro_torch train --arch qwen2-0.5b --smoke --device cpu --steps 3 \\
        --pp 2 --n-micro 4 --pp-schedule wave --set parallel.n_chunks=2 --modules dpp
    python -m repro_torch train --arch qwen2-0.5b --smoke --device cpu --steps 3 \\
        --set parallel.dp=2 --set parallel.tp=2          # 4 spawned ranks
    python -m repro_torch train --arch qwen2-0.5b --smoke --device cpu --steps 8 \\
        --set train.seq_len=64 --modules scan,metrics --trace-out t.json \\
        --metrics-out m.jsonl --ckpt-dir ckpt --ckpt-every 4
    python -m repro_torch serve --arch qwen2-0.5b --continuous
    python -m repro_torch serve --arch qwen2-0.5b --smoke --continuous --device cpu
    python -m repro_torch serve --arch qwen2-0.5b --smoke --device cpu   # static
    python -m repro_torch serve --arch qwen2-0.5b --smoke --continuous --device cpu \
        --chunked-prefill        # or --spec-decode [--drafter random],
                                 # --decode-path gathered, --modules scope
    python -m repro_torch serve --arch qwen2-0.5b --continuous --replicas 2 \
        --router-policy jsq [--prefill-replicas 1] [--slo-ttft S] [--traffic bursty]
    python -m repro_torch serve --arch qwen2-0.5b --continuous --compile-cache cc
    python -m repro_torch trace --slow-rank 5 --iters 2 --out artifacts/megascan
    python -m repro_torch dryrun --arch qwen2-0.5b --shape train_4k
    python -m repro_torch dryrun --all --host-mesh --out artifacts/dryrun

The flag table is the JAX CLI's, with the same layering (most specific
last): dataclass defaults -> workload defaults -> ``--config`` JSON ->
``--set a.b=v`` overrides -> explicit flags, through
:func:`repro_torch.app.config.build_run_config`.  ``--modules`` toggles
the module plugins (``scan`` and ``metrics`` by default for train and
serve; ``none`` disables all), ``--trace-out`` exports the run's MegaScan
events as a chrome trace (streaming a ``.jsonl`` sidecar while it runs) and
``--metrics-out`` streams the metrics registry as JSONL.  The port's own
flag is ``--device``: the workloads run on the card unless ``--device cpu``
is given.  Flags that select a later slice's path are accepted and refused
with ``NotImplementedError``'s message, naming the ROADMAP item; the
dryrun's ``--multi-pod on|both`` and ``--save-hlo`` are refused with the
reason (no TPU pod mesh, no HLO text on the card).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from repro_torch.app.config import build_run_config

# (flag, dest RunConfig path, argparse kwargs) — only flags the user actually
# passed are applied (argparse.SUPPRESS), so they override --config/--set
_SHARED = [
    ("--arch", "arch", dict(type=str)),
    ("--smoke", "smoke", dict(action="store_true")),
    ("--seed", "seed", dict(type=int)),
    ("--device", "runtime.device", dict(
        choices=("cuda", "cpu"),
        help="cuda (default; raises without a card) or cpu")),
    ("--modules", "modules", dict(
        type=str, metavar="M1,M2",
        help="module plugins to attach (scan,metrics,scope,fbd,dpp,ft; "
             "'none' = off)")),
    ("--mesh", "mesh", dict(
        choices=("auto", "auto-mp", "host", "pod1", "pod2"))),
    ("--trace-out", "trace_out", dict(
        type=str, help="export this run's TraceEvents as a chrome trace "
                       "(a .jsonl path streams instead; non-.jsonl paths "
                       "also stream a .jsonl sidecar while running)")),
    ("--metrics-out", "obs.metrics_out", dict(
        type=str, help="stream the metrics registry as JSONL time series")),
    ("--compile-cache", "runtime.compile_cache", dict(
        type=str, metavar="DIR",
        help="persistent compile cache: the kernels' builds and the warm-up "
             "records; a continuous server precompiles its buckets through it")),
    ("--detect-online", "scan.detect_online", dict(
        action="store_true",
        help="run MegaScan's straggler detector over a sliding window of "
             "TraceEvents during the run (see --set scan.* thresholds)")),
]

_TRAIN = [
    ("--pp", "parallel.pp", dict(
        type=int, help="pipeline stages (>1 routes blocks through MegaDPP, "
                       "each stage a process: the CLI spawns pp*dp*tp ranks "
                       "with parallel.dp/tp, or joins torchrun's)")),
    ("--pp-schedule", "parallel.schedule", dict(
        choices=("1f1b", "dfc", "bfc", "wave"))),
    ("--n-micro", "parallel.n_micro", dict(
        type=int, help="pipeline microbatches per step (0 = 2*pp)")),
    ("--steps", "train.steps", dict(type=int)),
    ("--global-batch", "train.global_batch", dict(
        type=int, help="0 = 8 smoke / 256 full")),
    ("--seq-len", "train.seq_len", dict(
        type=int, help="0 = 128 smoke / 4096 full")),
    ("--lr", "train.lr", dict(type=float)),
    ("--schedule", "train.schedule", dict(choices=("cosine", "wsd", "constant"))),
    ("--warmup-steps", "train.warmup_steps", dict(
        type=int, help="0 = max(steps // 10, 5)")),
    ("--grad-accum", "train.grad_accum", dict(type=int)),
    ("--ckpt-dir", "train.ckpt_dir", dict(
        type=str, help="checkpoint every --ckpt-every steps; resume from "
                       "the latest checkpoint found there")),
    ("--ckpt-every", "train.ckpt_every", dict(type=int)),
    ("--max-restarts", "ft.max_restarts", dict(
        type=int, help="bounded restarts for the supervised loop "
                       "(the ft module; see --set ft.* / ft.chaos.*)")),
    ("--chaos-crash-at", "ft.chaos.crash_at_step", dict(
        type=int, metavar="STEP",
        help="chaos: inject a real crash at this step (needs --ckpt-dir "
             "and the ft module; one of the --set ft.chaos.* knobs)")),
    ("--multi-pod", "mesh", dict(action="store_const", const="auto-mp")),
]

_SERVE = [
    ("--continuous", "serve.continuous", dict(
        action="store_true",
        help="MegaServe continuous batching (without it: the static "
             "lockstep baseline)")),
    ("--batch", "serve.batch", dict(type=int)),
    ("--prompt-len", "serve.prompt_len", dict(type=int)),
    ("--max-new", "serve.max_new", dict(type=int)),
    ("--temperature", "serve.temperature", dict(type=float)),
    ("--requests", "serve.requests", dict(type=int)),
    ("--rate", "serve.rate", dict(
        type=float, help="Poisson arrival rate, requests/s")),
    ("--slots", "serve.slots", dict(type=int)),
    ("--block-size", "serve.block_size", dict(type=int)),
    ("--num-blocks", "serve.num_blocks", dict(
        type=int, help="physical KV blocks (0 = size for zero preemption)")),
    ("--prompt-lens", "serve.prompt_lens", dict(type=str)),
    ("--decode-path", "serve.decode_path",
     dict(choices=("auto", "paged", "gathered"))),
    ("--prefill-path", "serve.prefill_path",
     dict(choices=("auto", "flash", "dense"))),
    ("--spec-decode", "serve.spec_decode", dict(action="store_true")),
    ("--spec-k", "serve.spec_k", dict(type=int)),
    ("--drafter", "serve.drafter", dict(choices=("ngram", "random"))),
    ("--chunked-prefill", "serve.chunked_prefill", dict(action="store_true")),
    ("--chunk-len", "serve.chunk_len", dict(type=int)),
    ("--traffic", "serve.traffic", dict(
        choices=("poisson", "bursty", "diurnal"))),
    ("--replicas", "router.replicas", dict(type=int)),
    ("--router-policy", "router.policy", dict(
        choices=("round_robin", "least_kv", "jsq"))),
    ("--prefill-replicas", "router.prefill_replicas", dict(type=int)),
    ("--slo-ttft", "router.slo_ttft_s", dict(type=float)),
]

_TRACE = [
    ("--load", "trace.load", dict(type=str, help="analyse a JSONL trace")),
    ("--detect", "trace.detect", dict(
        type=str, metavar="TRACE",
        help="load a saved trace (chrome .json or streamed .jsonl), run "
             "align + detect, print the diagnosis summary")),
    ("--out", "trace.out", dict(type=str)),
    ("--slow-rank", "trace.slow_rank", dict(type=int)),
    ("--slow-factor", "trace.slow_factor", dict(type=float)),
    ("--dp", "trace.dp", dict(type=int)),
    ("--pp", "trace.pp", dict(type=int)),
    ("--tp", "trace.tp", dict(type=int)),
    ("--n-micro", "trace.n_micro", dict(type=int)),
    ("--iters", "trace.n_iters", dict(type=int)),
]

_DRYRUN = [
    ("--shape", "dryrun.shape", dict(type=str)),
    ("--all", "dryrun.all", dict(action="store_true")),
    ("--multi-pod", "dryrun.multi_pod", dict(choices=("off", "on", "both"))),
    ("--profile", "dryrun.profile", dict(type=str)),
    ("--grad-accum", "dryrun.grad_accum", dict(type=int)),
    ("--out", "dryrun.out", dict(type=str)),
    ("--save-hlo", "dryrun.save_hlo", dict(action="store_true")),
    ("--host-mesh", "dryrun.host_mesh", dict(action="store_true")),
]

_WORKLOAD_FLAGS = {"train": _TRAIN, "serve": _SERVE, "trace": _TRACE,
                   "dryrun": _DRYRUN}

_REPORTS = ("scan", "metrics", "scope", "fbd", "dpp", "ft", "parallel", "precompile",
            "trace_out")


def _add_flags(ap: argparse.ArgumentParser, flags) -> None:
    # the dest encodes the RunConfig path ("train.steps" -> "train__steps");
    # build_run_config reverses the mapping
    for flag, path, kw in flags:
        ap.add_argument(flag, dest=path.replace(".", "__"),
                        default=argparse.SUPPRESS, **kw)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="MegatronApp repro, PyTorch/CUDA port: one CLI for every "
                    "workload; module plugins toggle with --modules.",
    )
    sub = ap.add_subparsers(dest="workload", required=True)
    for wl, flags in _WORKLOAD_FLAGS.items():
        p = sub.add_parser(wl)
        p.add_argument("--config", default=None,
                       help="JSON RunConfig overlay (nested sections)")
        p.add_argument("--set", dest="sets", action="append", default=[],
                       metavar="KEY=VALUE",
                       help="dotted typed override, e.g. train.seq_len=64")
        _add_flags(p, _SHARED)
        _add_flags(p, flags)
    return ap


def parse(argv: list[str]):
    """``(workload, RunConfig)`` from command-line arguments."""
    args = build_parser().parse_args(argv)
    flag_overrides = {
        k: v for k, v in vars(args).items()
        if k not in ("workload", "config", "sets")
    }
    cfg = build_run_config(args.workload, config_json=args.config,
                           sets=args.sets, **flag_overrides)
    return args.workload, cfg


def run(argv: list[str], *, model_cfg=None) -> dict:
    """Parse and run a workload.  Returns ``{"session": Session}`` (its
    ``results`` hold the plugin reports under the JAX package's names) and
    the workload's own keys: train's ``history``; serve's ``metrics`` and,
    continuous, ``streams`` and ``serve_config`` or, static, ``outputs``
    and ``prompts``; trace's ``diagnosis`` (and ``truth``
    when simulated); dryrun's ``cells`` (``{tag: result or {"error"}}``,
    exiting with the failed tags when any cell failed).  ``model_cfg``
    overrides the ``--arch`` lookup."""
    from repro_torch.app.session import Session

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    workload, cfg = parse(argv)
    session = Session(cfg, model_cfg=model_cfg)
    out = session.run()
    res = session.results
    reports = {k: res[k] for k in _REPORTS if k in res}
    if workload == "train":
        _, history = out
        tc = res["train_config"]
        print(f"arch={session.model_cfg.name} device={session.device} "
              f"seq_len={tc['seq_len']} global_batch={tc['global_batch']} "
              f"grad_accum={tc['grad_accum']} steps={tc['steps']}", flush=True)
        for h in history:
            print(f"step {h['step']:>5}  loss {h['loss']:.4f}  "
                  f"lr {h['lr']:.2e}  grad_norm {h['grad_norm']:.4f}  "
                  f"step_ms {1e3 * h['step_s']:.1f}")
        print(json.dumps(reports, default=str))
        return {"session": session, "history": history}
    if workload == "serve" and not cfg.serve.continuous:
        gen, met = out
        s = cfg.serve
        print(f"arch={session.model_cfg.name} static device={session.device} "
              f"batch={s.batch} prompt={s.prompt_len} new={s.max_new}")
        print(f"prefill: {met['prefill_s'] * 1e3:.1f} ms "
              f"({met['prefill_tok_s']:.0f} tok/s)")
        print(f"decode : {met['decode_s'] * 1e3:.1f} ms "
              f"({met['decode_tok_s']:.0f} tok/s)")
        for b in range(min(s.batch, 2)):
            print(f"  seq {b}: {gen[b][:12]}...")
        print(json.dumps(reports, default=str))
        return {"session": session, "metrics": met, "outputs": gen,
                "prompts": res["static_prompts"]}
    if workload == "serve":
        outs, met = out
        sc = res["serve_config"]
        s = cfg.serve
        routed = sc["replicas"] > 1 or sc["policy"]
        print(f"arch={session.model_cfg.name} continuous "
              f"device={session.device} slots={sc['num_slots']} "
              f"blocks={sc['num_blocks']}x{sc['block_size']} "
              f"requests={len(outs)} decode_path={res['decode_path']} "
              f"prefill_path={res['prefill_path']}"
              + (f" spec_k={s.spec_k} drafter={s.drafter}" if s.spec_decode
                 else "")
              + (" chunked_prefill" if s.chunked_prefill else "")
              + (f" replicas={sc['replicas']} policy={sc['policy']}" if routed
                 else "")
              + (f" traffic={sc['traffic']}" if sc["traffic"] != "poisson"
                 else ""))
        keys = ["generated_tokens", "wall_s", "tokens_per_s", "ttft_p50_s",
                "ttft_p99_s", "queue_wait_p50_s", "queue_wait_p99_s",
                "latency_p50_s", "latency_p99_s", "preemptions", "steps"]
        if routed:
            keys += ["shed", "shed_rate", "redirects", "migrations",
                     "placed_per_replica", "replica_tokens", "load_skew"]
        if s.spec_decode:
            keys += ["spec_proposed", "spec_accepted", "spec_accept_rate"]
        for k in keys:
            v = met[k]
            print(f"  {k:16s} {v:.4f}" if isinstance(v, float) else f"  {k:16s} {v}")
        for rid in list(outs)[:2]:
            print(f"  req {rid}: {outs[rid][:12]}...")
        print(json.dumps(reports, default=str))
        print(json.dumps({"serve_config": sc}))
        return {"session": session, "metrics": met, "streams": outs,
                "serve_config": sc}
    if workload == "dryrun":
        failed = [t for t, v in out.items() if "error" in v]
        if failed:
            raise SystemExit(f"{len(failed)} cell(s) failed: {failed}")
        return {"session": session, "cells": out}
    # trace
    print(json.dumps(res["diagnosis"], indent=1))
    if "truth" in res:
        t = res["truth"]
        print(f"slow-rank detection: "
              f"{'CORRECT' if t['detected'] else 'MISMATCH'} "
              f"(truth={t['slow_ranks']})")
    return {"session": session,
            **{k: res[k] for k in ("diagnosis", "truth") if k in res}}


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
