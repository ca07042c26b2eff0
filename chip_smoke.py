#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each of which fails the run (non-zero exit) on error:

1. device  — requires a CUDA card; prints its name and power limit;
2. build   — compiles the CUDA kernels from ``src/repro_torch`` with nvcc and
             prints ptxas' registers / shared memory / spills;
3. kernels — holds each kernel against its plain PyTorch version on the card
             (the K5 and K6 checks are listed under their phases below):
             paged decode and prefill (K3, K4) at qwen2-0.5b widths (H=14,
             K=2, dh=64, block 16), at qwen3-14b's (dh 128, qk_norm) and the
             smoke width (dh 16), at K3's split edges and K4's tile edges,
             K3 also at recurrentgemma-9b's (H=16, K=1, dh=256, window 2048,
             its first live position across split edges, and on float32
             queries), K4 also at the served verify shape (8 slots, Q=5,
             ragged kv_len, pad rows past a table's reach) and chunk shapes
             (Q=32 and 256 over a cached prefix), K3 and K4 also at
             minitron-4b's heads (24 / 8 / 128, G = 3), minicpm-2b's (36 /
             36 / 64, MHA) and phi3.5-moe's (32 / 8 / 128, G = 4), held row by
             row; RMSNorm forward and backward (K1, Triton;
             also at rwkv6-3b's width 2560, recurrentgemma-9b's 4096 and
             the widths 2304, 3072 and 3584, none a power of two) and
             flash attention forward and backward (K2) at the training
             path's shapes (qwen2-vl-7b's 28 / 4 / 128, minicpm-2b's and
             phi3.5-moe's too), at small ragged ones and across its tiles'
             edges (head dims 16 to 256; v's head dim apart from q's at
             deepseek-v2-lite's 192 / 128, H = K = 16, and its smoke
             config's 24 / 16, a window and tile edges included; and
             bidirectional at seamless-m4t's MHA 16 x 64: its training
             shape, a cross shape with S apart from T, tile edges; a
             tensor rank's share of qwen2-0.5b's heads at tp 2, H 7, K 1),
             its backward bit-identical on a second run, K1 also at MLA's
             latent width 512, all bfloat16; then times kernel, plain version and
             a library yardstick the port never calls
             (``scaled_dot_product_attention``, its backward alone for K2's
             backward; ``F.rms_norm``, its backward alone for K1's backward,
             K1 and its yardstick through CUDA graphs) at the main paths'
             shapes (K3 also at one Griffin decode tick, dh 256; K4 also
             at one verify step and one 32-token chunk; K3 and K4 at
             minitron's and minicpm's heads, K2 at qwen2-vl's and minicpm's
             training shapes, K1 at 2304, 3072 and 3584, logged; K2 at
             deepseek-v2-lite's training shape, with the SDPA backends
             that take v's width apart, and K1 at [4096, 512]; K2
             bidirectional at seamless-m4t's training shape, SDPA with
             ``is_causal=False``), and splits K2's backward into its
             kernels under ``torch.profiler``;
4. serve   — full-width qwen2-0.5b (24 layers, random weights from a seed)
             served by MegaServe on 32 Poisson requests after
             ``precompile()`` (every bucket warmed, the launch counts left
             at 0); every decode tick and every prompt must launch each
             paged kernel once per layer and the RMSNorm kernel once per
             norm (the check phase's Session runs, which do not
             precompile, must stream the same tokens);
   precompile — two fresh ``python -m repro_torch serve --arch qwen2-0.5b
             --continuous`` processes through one ``--compile-cache``
             directory, empty the first time: the cold one runs nvcc for
             the libraries its buckets launch (misses and puts), the warm
             one runs none (hits equal to the cold one's puts, no miss, no
             new file in the cache, Triton's included); both report per-path
             ``{count, ms}`` and stream the same tokens;
   generate — ``generate_with_scope`` (MegaScope) on the serve phase's
             weights: a 128-token prompt of seed 1, 32 greedy steps over the
             dense KV cache with probes on the final hidden state and the
             attention probabilities; its tokens against MegaServe's greedy
             stream for the prompt, the teacher-forced logits of its tokens
             through the serving kernels and through the dense cache within
             ``LOGIT_TOL``, K1 once a norm a forward; ms per generated token
             (host clock); a dashboard from the last step's attention and a
             PCA of the final hidden states, its markers checked; then a
             1100-token prompt of seed 2, 4 steps, held the same way, whose
             prefill takes the dense cache's chunked attention (one call a
             layer, counted);
5. check   — replays finished streams teacher-forced through the kernel path
             and through the plain path on the card and compares the logits;
             then times one decode tick at the serve shape on the host clock
             and, under torch.profiler, its kernels' device time: the
             device's idle share of a tick; then the same workload through
             ``Session`` (``python -m repro_torch serve --continuous
             --modules scan,metrics``, then in turns with ``scan``, then
             ``none``): streams token-identical to the direct run's, the
             paged kernels' exact launches, one TTFT sample a request in
             the metrics registry, the tick medians beside the direct
             run's;
   serve-paths — MegaServe's single-engine paths on the serve phase's
             model and pool, 8 Poisson requests (prompts 128/512/2048, 8-32
             new tokens): the paged flash path; chunked prefill (chunks of
             32); speculation (spec_k 4) with the n-gram drafter, then with
             a drafter replaying that run's streams (all drafts accepted,
             or a rejection at a near-tie, logged); a ``final_hidden``
             stats probe on the gathered path (2 requests); each also
             through ``Session``, and static serving (batch 4 x 128, 16
             new) through it against ``StaticRunner``.  Every request
             finished, K4, K3 and K1 launched exactly as the prefills,
             chunks, verify steps and ticks say, the chunked and
             speculative streams teacher-forced through their own paths
             (chunks of 32; verify rows of 5), kernels against plain,
             within ``LOGIT_TOL``, a capture on every gathered-path token,
             the Session's chunked streams the direct run's, the static
             outputs ``StaticRunner``'s; tokens/s, TTFT, tick medians,
             acceptance and tokens per verify step logged;
   route   — MegaRoute: the serve phase's model and workload through a
             ``Router`` over two MegaServe replicas (8 slots each) that
             share one cast of the weights (resident and peak memory of
             one replica and of two, against one pool), ``precompile()``
             over both replicas' ladders (the launch counts unmoved):
             colocated under
             jsq and under round_robin, then disaggregated (replica 0
             prefill-only, every request migrating its slot to replica
             1); every request finished, K4, K3 and K1 launched exactly
             as the fleet's events say and, counted a replica through
             ``replica_wrap_steps``, only where they belong (K4 24 x 32 on
             the prefill replica, K3 on the decode replica alone), 32
             migrations, streams against the serve phase's single engine
             and the colocated run's (a stream that parts is replayed
             plain and its top-2 margin there must lie within
             ``LOGIT_TOL``), the jsq streams teacher-forced, kernels
             against plain; ``export_slot``/``import_slot`` round trip at
             the serve pool's width on the card (``torch.equal``, timed
             with CUDA events); then ``python -m repro_torch serve
             --continuous --replicas 2 --router-policy jsq --traffic
             bursty --modules scan,metrics``: the ``router.*`` counters,
             the ``serve.r0.``/``serve.r1.`` series, route events and
             lanes 0, 1 and 2 in its trace; tokens/s, TTFT, queue wait,
             placement, load skew, the router tick median and the
             kv_export/kv_import ms and GB/s logged for each run;
   serve-rwkv6, serve-griffin — rwkv6-3b (4 of its 32 layers) and
             recurrentgemma-9b (6 of its 38, 2 of them attention) at full
             width served by MegaServe, seed-0 weights, bf16, 8 slots: 16 and 12
             Poisson requests (prompts 127/1000/2047 and 100/2048/3000, the
             latter decoding past Griffin's window of 2048) prefilled in
             pow2 segments; every request finished with a valid stream, K1
             launched exactly (2L + 1) x (decode ticks + the prompts' pow2
             segments) times, K3 exactly ticks x its attention layers
             (Griffin), no K4, K5, K6 or K1 backward; teacher-forced
             logits through the kernels
             and the plain versions within ``LOGIT_TOL`` in float32, the
             bf16 replays and a noise probe logged (see ``LOGIT_TOL``);
             tokens/s, TTFT, prefill ms by prompt length, the median tick,
             peak memory and one tick's host and device time;
   generate-recurrent — ``generate_with_scope`` on rwkv6-3b (2 layers)
             and recurrentgemma-9b (3), full width, over the carried state,
             held as the generate phase holds qwen2's;
   serve-dense, serve-moe — minitron-4b (16 of its 32 layers) and
             minicpm-2b (20 of 40) at full width, and phi3.5-moe at full
             width cut to
             8 of its 32 layers (its float32 init freed once the server
             holds the bf16 copy), seed-0 weights, bf16, 8 slots, 12
             Poisson requests at 40/s (prompts 128/512/2048, 16-32 new
             tokens): every request finished, K4 L times a prompt, K3 L
             times a tick, K1 2L + 1 times a forward, no K1 backward; the
             teacher-forced logits of one stream per prompt length,
             kernels against plain, within ``LOGIT_TOL`` (phi3.5-moe's
             plain replay routed as the kernel replay routed, the routing
             flips held to ``MOE_FLIP_SHARE``, the replay on its own
             routing and a noise probe logged); tokens/s, TTFT, the tick median, one tick's
             host and device time, peak memory, phi3.5-moe's
             ``moe_drop_frac`` by path;
   serve-mla — deepseek-v2-lite-16b (MLA over 64 routed experts) at 5
             of its 27 layers, its seed-0 weights drawn in bf16 leaf by leaf,
             the same 12 requests on the gathered path (the latent cache
             has no kv-head axis for K3 or K4; the dense prefill): every
             request finished, K1 3L + 1 times a forward (a prefill or a
             slot's B=1 decode forward), K2 L times a prefill longer than
             ``attn_kv_chunk``, nothing else; the teacher-forced logits
             through the dense-cache forward at the served cache length,
             kernels against plain, pinned, within ``LOGIT_TOL`` (the
             routing flips held to ``MOE_FLIP_SHARE`` above the noise
             probe's); tokens/s, TTFT, the tick, one gathered tick's host
             and device time, the init peak, ``moe_drop_frac``;
   serve-encdec — seamless-m4t-large-v2 (the encoder-decoder, 24 + 24
             layers, layernorm) at full width and depth served statically
             through ``Session`` (``serve --arch seamless-m4t-large-v2``,
             batch 4, 2048-token prompts over 2048 source frames, 32 new):
             K2 launched exactly once an encoder layer (bidirectional) and
             once a decoder layer (the cross-attention) in the prefill,
             nothing else; the served tokens teacher-forced through the
             kernels and the plain versions, logits within ``LOGIT_TOL``,
             argmax agreements logged; prefill ms, decode ms a step,
             tokens/s, peak memory;
6. train   — full-width qwen2-0.5b trained 8 steps at seq 2048 x batch 8
             through ``Session`` (``python -m repro_torch train --modules
             scan,metrics --trace-out ... --metrics-out ... --set
             obs.peak_tflops=989``); launches must equal the counts worked
             out from the depth and full remat for the 8 steps' forward-and-
             backward passes (the flop count runs on the meta device and
             launches nothing), every loss must be
             finite and the last below the first; one more step under
             ``torch.profiler`` splits its device time by kernel family
             (also in phases 8 and 9); the chrome trace, its ``.jsonl``
             sidecar and the metrics file must hold the run's spans and
             losses, ``mfu_est`` must lie in (0, 1); then the same run with
             ``--modules none`` (exact launches for 8 steps), and the pair
             again in the other order, for the median steps beside;
7. step    — the loss and gradients of one batch, from the parameters of the
             seed, through the kernels and through the plain versions: loss,
             grad_norm and each layer's attention and norm gradient norms
             must agree;
   runtime — qwen2-0.5b at full width cut to 2 layers trained 8 steps with
             ``--ckpt-dir`` and ``--ckpt-every 4``, then resumed in a fresh
             ``Session`` from its step-4 checkpoint alone: the resumed
             losses, the two step-8 checkpoints and the restored state must
             equal the uninterrupted run's bit for bit; one ``save_async``
             timed (stall and background write); and ``python -m
             repro_torch trace --slow-rank 5 --iters 2`` must detect rank 5;
   ft      — MegaFT through ``python -m repro_torch train --modules
             scan,metrics,ft`` at the runtime phase's depth cut (2 layers),
             seq 2048 x batch 8, 14 steps: the chaos run of JAX's
             TestChaosAcceptance (``--detect-online``, a checkpoint every 3
             steps, a crash at step 5, rank 1 at half speed) ends on every
             loss of the fault-free run bit for bit, with two restarts (the
             crash, the exclusion), rank 1 excluded, detected before step
             8; a degraded link 0-1 switches int8 compression on once
             (wire bytes below bf16's; the step medians without and with
             it, the compressor's ms a step); a NaN batch rolled back ends
             on the fault-free losses, and skipped trips one guard with no
             restart; K1 and K2 launched exactly for the steps each run
             ran, replays included; save_async stall and restore ms;
   ft-world — in the pipeline phase's world of 2 ranks, 10 steps: dp 2
             with a crash and a degraded link (a restart on both ranks,
             compression on at the same step on both) and pp 2 with rank
             1 slow and ``ft.slow_frac_hard=1.1`` (replanned to a wave on
             both stages, rank 0's detector deciding); per-rank launches
             exact for the steps run, every step run held to the fused
             one-process step from the same parameters and each history
             to a one-process supervised run of the same plan and chaos,
             within ``STEP_LOSS_TOL``;
   scope   — ``stats_of`` on one layer's bf16 ``mlp_hidden`` against
             float64, with its time and the memory above its input (under a
             float32 copy's); then MegaScope through the qwen2 train step:
             4 steps through ``Session`` with ``--modules
             scan,metrics,scope`` (probes
             ``mlp_hidden:stats,att_resid:stats,q:channels``) and with
             ``--modules scan,metrics``, in turns (on, off, off, on): losses
             bit-identical, K1's and K2's launches the same, every capture
             finite with a leading axis of 24, one hit a step a leaf; the
             median steps and peak memory of both sides; then one step
             perturbed at a layer that does not exist (the same loss) and one
             with gaussian noise on ``att_resid`` (another, finite loss);
   fbd     — MegaFBD's decoupled forward/backward on the qwen2 loss at the
             train phase's shape, remat full: loss and every gradient leaf
             bit-identical to ``torch.autograd.grad``'s, also with the
             residuals moved to host memory and back between fwd and bwd;
             fwd and bwd timed with CUDA events; the residual bytes against
             their hand count; the ``fbd`` plugin's report;
   pipeline — MegaDPP, each stage a process: full-width, full-depth
             qwen2-0.5b trained 4 steps through ``Session`` at pp 2 (2
             chunks a stage, 4 microbatches, the planner's wave;
             ``--modules scan,metrics,dpp``) in a world of 2 ranks spawned
             on the card: each rank's K1 and K2 launches exact, losses
             finite and falling, 16 ``pp_F`` and 16 ``pp_B`` events a step
             on stage pids 0 and 1, the ``dpp`` report and
             ``results["parallel"]``; the pipelined loss and gradients of
             one batch (one process) against the fused ones at the step
             check's limits; MegaFBD attached (``parallel.fbd_backward``,
             a stage's backward on the other stage's process): 2 steps
             bit-identical to those without it, and the decoupled
             pipelined loss's gradients (one process) bit-identical to
             ``torch.autograd.grad``'s, also after the residuals' round
             trip through host memory, ``fwd``/``bwd`` timed with CUDA
             events; rwkv6-3b at full width cut to 4 layers through the
             pipeline (K5 and K1 launches exact on each rank, losses
             falling, the pipelined loss of one batch within
             ``RWKV_STEP_LOSS_TOL`` of the fused one); then the fused step
             and the four schedules (1f1b, dfc, bfc, wave) at the qwen2
             shape and full depth: each table's T and bubble fraction, the
             median step, the peak memory per rank;
   parallel — data, tensor and stage parallelism through ``python -m
             repro_torch``'s entry point at qwen2-0.5b's full width and
             depth, seq 2048, 3 steps, ranks spawned on the one card
             (gloo; one world of 2 ranks for dp 2 and tp 2 at batch 2 and
             pp 2 with each stage a process and MegaFBD's backward on the
             other stage's at batch 4 in 4 microbatches, one of 4 for pp 2
             x dp 2 at batch 4, two microbatches a dp group): every step
             (loss, grad norm, per-layer leaf gradient norms) held to the
             fused one-process step from the same parameters at the qwen2
             step limits, data replicas ending on the same weights, each
             rank's K1 and K2 launches exact, the backend gloo; the step
             medians beside the fused step's and the share of a step in
             all-reduces;
8. rwkv    — the WKV6 kernels (K5, forward and backward) held row by row to
             their plain version in float64 at the rwkv6-3b training shape
             and at ragged, brutal-decay, long-memory, clamped-decay and
             chunk-edge ones, timed, and split into their kernels under
             ``torch.profiler``; then full-width, full-depth rwkv6-3b trained 6
             steps at seq 2048 x batch 4 (launches per step exact, losses
             finite and falling), and the step check at 4 layers;
9. griffin — the RG-LRU kernels (K6, forward and backward) held row by row
             to their plain version in float64 at the recurrentgemma-9b
             training shape [2, 4096, 4096] and at ragged, brutal-decay,
             long-memory and window-edge ones (T not a multiple of the
             window, a grid far below 132 blocks), bit-identical on a
             second run, and timed through CUDA graphs; K2 at head dim
             256 (MQA, window 2048) at the training shape and at S <
             window, K1 at width 4096, all timed; then
             full-width recurrentgemma-9b cut to 5 of its 38 layers trained
             6 steps at seq 4096 x batch 2 (parameter count, launches per
             step exact, losses finite and falling), and the step check at
             the same 5 layers; then one train step each of rwkv6-3b at 2
             layers (probe ``wkv_decay:stats``) and recurrentgemma-9b at 3
             (rec, rec, attn; probe ``rglru_out:stats``), full width, with
             and without the probe: losses bit-identical, K5, K6, K2 and K1
             launched as often, captures finite;
   train-configs — qwen2-vl-7b at full width cut to 4 of 28 layers
             through ``make_train_step`` on a ``make_batch`` batch (input
             embeddings, M-RoPE ids), seq 2048 x batch 4; minicpm-2b at
             full depth through ``Session`` (``train --arch minicpm-2b``,
             the wsd schedule), 2048 x 4; phi3.5-moe cut to 2 of 32
             layers through the loop, 2048 x 2, its aux loss and
             ``seg0_moe_drop_frac`` in every step's metrics; 4 steps each:
             K2 and K1 launched exactly as counted for full remat, losses
             finite and falling, one more step under ``torch.profiler``;
             then each one's step check at the qwen2 check's limits
             (qwen2-vl's on a patch grid's M-RoPE ids, phi3.5-moe's plain
             run routed as the kernel run routed, the routing flips held
             to ``MOE_FLIP_SHARE``);
   train-mla — deepseek-v2-lite at full width cut to 4 of 27 layers
             through the loop with a metrics registry, 2048 x 2, 4 steps,
             data seed 2: parameter count, K2 (q/k 192, v 128) 2L / L and
             K1 (6L + 1) / (3L + 1) a pass (the flop count launches none),
             losses falling, the profiler's split, ``mfu_est``; its step
             check, pinned;
   train-encdec — seamless-m4t-large-v2 at full width and depth (2.04 B
             parameters, ~36.6 GB of train state) through
             ``make_train_step`` on one ``make_batch`` batch (frames and
             target tokens), 2048 x 4, 4 steps: K2 144 forwards and 72
             backwards a step (the encoder's, the cross-attention's, the
             decoder's), losses falling, the profiler's split,
             ``mfu_est``, peak memory; its step check;
10. dryrun  — ``python -m repro_torch dryrun --all`` over the full
             configs on the meta device, started in the background (at a
             lower priority) when the training phases begin: a line a
             cell with its seconds, each cell flops
             and a peak or a reasoned ``FAIL``; the wrappers' meta-device
             sizes against their libraries'; qwen2-0.5b's cell at 2048 x 8
             (full depth, remat full): ``peak_est_bytes`` within
             ``PEAK_RTOL`` of ``max_memory_allocated`` over one real step
             (seamless-m4t's, at the train-encdec phase's shape, is held
             the same way there), and its flops, the loop's meta count and
             a real pass's count one integer;
11. summary — a ``{"kernels": [...]}`` line, then the last line
             ``{"ok": true, "device": {...}}``.

Needs the CUDA toolkit (nvcc) and PyTorch built for CUDA; imports no JAX.
"""

from __future__ import annotations

import contextlib
import cProfile
import gc
import io
import json
import math
import os
import pstats
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

H, K, DH, BS = 14, 2, 64, 16           # qwen2-0.5b attention widths
HBM_BYTES_PER_S = 3.35e12              # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12              # H100 SXM dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12                # H100 SXM float32 outside the tensor cores
# K3 and K4 on bfloat16 N(0, 1) inputs are held row by row, as K2 is
# (FLASH_ROW_RTOL below): a row is one (slot, query, head) output vector of
# dh entries, its error max |kernel - plain| over the row divided by the
# row's largest |plain| entry.  A row of a long kv_len averages thousands of
# values and is ~0.05 where a short one is O(1), so a limit on the whole
# tensor would be as large as a long row itself: a dropped split or kv tile
# moves one row and could pass it.  Both sides round each entry to bfloat16
# once (an ulp is at most 2^-7 of the row's largest entry).  The plain
# version rounds the normalised probabilities to bfloat16 before the PV
# product; K3 keeps them float32 (each split's and the combine's sums in
# their own order), K4 rounds the unnormalised ones (P8 in ROADMAP.md); and
# K4's in-kernel rope may differ from PyTorch's by a float32 ulp, flipping a
# bfloat16 rounding of q.  Each moves a row by a few 2^-9 at most.
# teacher-forced logits, kernel path vs plain path, 24 bfloat16 layers:
# differences of a few bfloat16 ulps per layer compound through the residual
# stream; logits of this random model are O(1) to 5 (ulp 2^-6 at 4)
LOGIT_TOL = 0.25
# The served recurrent models (random seed-0 weights, bfloat16) turn any
# change of rounding into as much or more: rwkv6-3b's teacher-forced logits
# (32 layers) move by 0.16-1.37 when only the plain RMSNorm rounds from
# float64 instead of float32 (the noise probe of teacher_forced), about as
# far as the kernels' own roundings move them (0.43-1.31), the difference
# growing with the prompt along the carried state; recurrentgemma-9b's (38
# layers) by 0.20-0.32, its kernels' by 0.21-0.30 (H100 80GB HBM3 at 700 W,
# the serve phases' streams).  So their kernel paths
# are held to LOGIT_TOL in float32 (both replays in float32 over the served
# weights: K1 on float32 rows, K3 on float32 queries over the bfloat16
# pool), the bfloat16 replays logged beside with the probe
SERVE = dict(n=32, rate=40.0, prompt_lens=(128, 512, 2048),
             max_new_range=(16, 64), num_slots=8, block_size=BS, seed=0)
# one decode tick of the serve phase's shape: 8 slots at kv_len of prompts
# 128/512/2048 plus generated tokens, table width 132
TICK_KV_LENS = [2112, 544, 160, 2080, 530, 140, 2100, 600]
# the serve_paths phase: MegaServe's single-engine paths on qwen2-0.5b at full
# width and depth, the serve phase's weights and pool, 8 Poisson requests a
# mode (the CLI derives max_new's lower end as max_new // 4, so the direct
# runs take the Session's 8-32); chunked prefill at the default chunk of 2
# blocks, speculation at spec_k 4; the MegaScope probe on the gathered path
# serves the first 2 requests; static serving a batch of 4 prompts of 128
PATHS = dict(n=8, rate=40.0, prompt_lens=(128, 512, 2048), max_new_range=(8, 32),
             num_slots=8, block_size=BS, seed=0)
CHUNK = 2 * BS
SPEC_K = 4
SCOPE_REQUESTS = 2
STATIC = dict(batch=4, prompt_len=128, max_new=16)
# a verify step's kv_len for the kernel rows: TICK_KV_LENS with the first
# slot 3 positions past its 132-entry table (its pad rows)
VERIFY_PAD_KV_LENS = [2115, 544, 160, 2080, 530, 140, 2100, 600]
# the recurrent families served: rwkv6-3b and recurrentgemma-9b at full width
# (depths below), seed-0 weights, bf16, 8 slots of block 16.  rwkv6's prompts run
# pow2 segments of both WKV forms (127 = 64 + 32 + 16 + ... + 1, 2047 all
# eleven widths); Griffin's decode passes position 2048, where its window
# masks, and its table width is 192 (3000 + 64 tokens)
RWKV_SERVE = dict(n=16, rate=40.0, prompt_lens=(127, 1000, 2047),
                  max_new_range=(16, 64), num_slots=8, block_size=BS, seed=0)
GRIFFIN_SERVE = dict(n=12, rate=40.0, prompt_lens=(100, 2048, 3000),
                     max_new_range=(16, 64), num_slots=8, block_size=BS, seed=0)
# the depths served (full width): rwkv6-3b at 4 of its 32 layers,
# recurrentgemma-9b at 6 of its 38 (2 attention layers), so that the ft,
# precompile and dryrun phases fit in the run's time limit on a slow host;
# PERF.md has both served at full depth
RWKV_SERVE_LAYERS = 4
GRIFFIN_SERVE_LAYERS = 6
# one Griffin decode tick: 8 slots at kv_len 2100-3064, table width 192
GRIFFIN_TICK_KV_LENS = [2100, 2238, 2376, 2514, 2652, 2790, 2928, 3064]
GRIFFIN_TICK_M = 192
GRIFFIN_TABLE = 192                    # Griffin's table width, at least 3000 + 64 tokens

# the training path's shapes: qwen2-0.5b, seq 2048 x batch 8, the data of
# SyntheticTokens' seed 0
TRAIN = dict(seq_len=2048, global_batch=8, steps=8, seed=0)
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
# the loss and gradients of one batch, kernels vs plain versions: the
# bfloat16 roundings that differ inside K1 and K2 (see above) move the loss
# and the global gradient norm; the global norm is dominated by the
# embedding and unembedding, so each layer's attention and norm gradients
# are also compared on their own (norm of the leaf's slice for that layer).
# Measured on an H100 80GB HBM3 at 700 W from the parameters of the seed
# (loss about 12.4, grad_norm about 16): 3.7e-4 absolute, 3.7e-4 relative,
# leaves at most 6.6e-3 relative, the k bias (from the state after 8 train
# steps, where these limits were set: 6.2e-5, 1.27e-4 and 2.2e-3, the k
# bias too).
STEP_LOSS_TOL = 1e-3
STEP_GNORM_RTOL = 1e-3
STEP_LEAF_RTOL = 1e-2

# rwkv6-3b: 40 WKV heads of 64, trained at seq 2048 x batch 4
RWKV_TRAIN = dict(seq_len=2048, global_batch=4, steps=6, seed=0)
RWKV_H, RWKV_N, RWKV_D = 40, 64, 2560
# the step check at full width and 4 layers: the bf16 noise it is held
# above grows with depth, and the limits below were measured at 4
RWKV_STEP_LAYERS = 4
# K5 against its plain version evaluated in float64 on the same inputs (the
# float32 chunked plain form loses digits of its own under brutal decay),
# held row by row as K2 is: a row is one token's (or one state row's, or
# one head's du) N entries, its error max |kernel - plain| over the row
# divided by the row's largest |plain| entry.  y, the final state, dw and du
# are float32 sums of up to T terms in another order: measured on an H100
# 80GB HBM3 at 700 W at the shapes below, at most 1.7e-5 (y) and 7.1e-5
# (dw), both under brutal decay, 3.4e-6 or less elsewhere; the limit is 7x
# the largest.  dr, dk and dv come back bfloat16: one rounding each, half a
# bfloat16 ulp, measured 2^-8 of the row's largest entry at every shape;
# the limit is one ulp, 2^-7.  A kernel that drops 8 tokens from
# the state in the long-memory case (w = 0.99966, where every token reaches
# the last) moves rows by far more than either: y by 0.36 of a row's
# largest entry, the state by 0.25, dr by 0.44, dw by 0.40 (plain versus
# plain with those keys zeroed, float64, B*H = 2, T = 512, on the CPU:
# tests/test_torch_wkv6.py::test_card_limits_catch_a_dropped_chunk_of_tokens).
WKV_F32_ROW_RTOL = 5e-4
WKV_BF16_ROW_RTOL = 2.0 ** -7
# the rwkv6 step check (4 layers, full width, seq 2048 x batch 4), kernels
# vs plain versions.  The loss keeps the qwen2 check's limit (measured
# 2.9e-4 on the H100).  The gradients cannot: at bf16 compute, the gradients of u, of the
# r, k and decay projections and of what feeds them are sums over 8192
# tokens whose terms nearly cancel (du = sum_t r_t * k_t (v_t . dy_t)), so
# a one-ulp bf16 difference upstream, such as K1's or K5's summation order
# flipping one rounding, moves them by percents.  The phase measures that
# floor in the same run (the noise probe: the plain path against itself with
# only the WKV evaluated in float64 instead of float32; on an H100 80GB HBM3
# at 700 W it moved grad_norm by 3.1e-3 and a layer's leaf norm by up to
# 1.3e-2, w0).  Kernels against plain measured 1.7e-2 on grad_norm and
# 4.9e-2 on the worst leaf (w_r), the K1 kernel flipping more roundings than
# the probe does; the limits are 3x those.  A wrong layout, a dropped bonus
# term or a wrong decay gradient moves these norms by O(1); the kernel
# checks above hold K5 row by row.
RWKV_STEP_LOSS_TOL = 1e-3
RWKV_STEP_GNORM_RTOL = 5e-2
RWKV_STEP_LEAF_RTOL = 0.15

# recurrentgemma-9b (Griffin) at full width, cut to 5 of its 38 layers
# (rec, rec, attn, rec, rec: one full pattern group and a 2-block
# remainder, as the published model ends), trained at seq 4096 x batch 2.
# Its data is SyntheticTokens' seed 2, not 0: the rule x -> a x + b mod V
# of seed 0 has a = 60, which shares the factors 2 and 5 of V = 256000 =
# 2^11 5^3, so every start reaches the rule's one fixed point within 6
# tokens and 94 % of the targets are one token (AdamW's sign-like first
# steps then overshoot and the loss swings between ~1 and ~30).  Seed 2's
# a = 56 is prime to 5, so the rule permutes the residues mod 5^3: apart
# from the noise, the targets run through cycles of at most 125 tokens,
# none over 1 % of them, a bigram rule to learn.
GRIFFIN_TRAIN = dict(seq_len=4096, global_batch=2, steps=6, seed=2)
GRIFFIN_LAYERS = 5
GRIFFIN_PARAMS = 3_223_498_752     # jax.eval_shape(lm.init) at 5 layers
GRIFFIN_W, GRIFFIN_H, GRIFFIN_DH, GRIFFIN_WINDOW = 4096, 16, 256, 2048
GRIFFIN_HEADS = (GRIFFIN_H, 1, GRIFFIN_DH)  # its attention: H, K (MQA), dh
# K6 against its plain version evaluated in float64 on the same inputs, held
# row by row (one token's W channels; y, h_last, da, db are float32): each
# step of the kernel's walk is one float32 FMA whose rounding error decays
# with a as the state does, so a row stays within a few float32 ulps (2^-24
# = 6e-8) of its largest entry.  Measured on an H100 80GB HBM3 at 700 W with
# a walk of all T tokens in float32: at most 1.8e-7 (da under brutal decay);
# the limit is 5x that.  The windowed chunk scan walks at most 8 tokens in
# float32 from a carry combined in float64, so it keeps that, long memory
# (a >= e^-0.01, where the carries dominate a row) included
# (tests/test_torch_rglru_chunks.py holds its float32 transcription to this
# limit).  A walk that drops one token's input moves later rows by over
# 1e-2 (tests/test_torch_rglru.py::test_card_limits_catch_a_dropped_token),
# one that drops a window edge's a_{t+1} or y_{t-1} by over 1e-3
# (tests/test_torch_rglru_chunks.py).
RGLRU_ROW_RTOL = 1e-6
# K2 at head dim 256 keeps K2's row-wise limits (FLASH_ROW_RTOL, LSE_TOL),
# and the Griffin step check the qwen2 step check's limits.
GRIFFIN_STEP_LOSS_TOL = 1e-3
GRIFFIN_STEP_GNORM_RTOL = 1e-3
GRIFFIN_STEP_LEAF_RTOL = 1e-2

# the dense configs and the MoE family (minitron-4b, minicpm-2b, qwen2-vl-7b,
# phi3.5-moe): their attention heads (H, K, dh) and model widths.  minitron
# groups 3 query heads a kv head, minicpm none (MHA, G = 1), phi3.5-moe 4,
# qwen2-vl 7
MINITRON_HEADS, MINITRON_D = (24, 8, 128), 3072
MINICPM_HEADS, MINICPM_D = (36, 36, 64), 2304
PHI_HEADS, PHI_D = (32, 8, 128), 4096
QWEN2VL_HEADS, QWEN2VL_D = (28, 4, 128), 3584
# serve-dense and serve-moe: 12 Poisson requests at 40/s, 8 slots;
# minitron-4b and minicpm-2b at half depth (16 of 32, 20 of 40 layers:
# the precompile and dryrun phases' time comes out of their host-paced
# ticks), phi3.5-moe cut to 8 of its 32 layers
# (10.7 B parameters: 21.3 GB in bf16 beside the 42.6 GB float32 init at
# the peak; all 32 would be 84 GB in bf16)
CONFIG_SERVE = dict(n=12, rate=40.0, prompt_lens=(128, 512, 2048),
                    max_new_range=(16, 32), num_slots=8, block_size=BS, seed=0)
DENSE_SERVE_LAYERS = {"minitron-4b": 16, "minicpm-2b": 20}
PHI_SERVE_LAYERS = 8
# train-configs: qwen2-vl-7b cut to 4 of 28 layers (2.02 B parameters, ~32
# GB of train state at 16 B a parameter; all 28 would be ~122 GB) through
# make_train_step on one make_batch batch (random targets: only a repeated
# batch has a loss to bring down); minicpm-2b at full depth through the
# Session (~44 GB); phi3.5-moe cut to 2 of 32 layers (2.86 B, ~46 GB)
QWEN2VL_TRAIN = dict(seq_len=2048, global_batch=4, steps=4, seed=0)
QWEN2VL_LAYERS = 4
MINICPM_TRAIN = dict(seq_len=2048, global_batch=4, steps=4, seed=0)
PHI_TRAIN = dict(seq_len=2048, global_batch=2, steps=4, seed=0)
PHI_TRAIN_LAYERS = 2
# MoE routing flips: the token routings whose top-k set differs between the
# kernel path and the plain path computed on the same pinned history
# (_PinnedRouting).  A bfloat16 near-tie that one ulp tips flips a few:
# 1.3-1.7 % of serve-moe's replays and 0.5 % of step-moe's on an H100; a
# kernel whose error leans one way moves many more.  The noise probe's
# flips (the plain path against itself with float64 norms) are logged beside.
# deepseek-v2-lite's router picks 6 of 64 experts: at random init its bf16
# router logits put the 6th and 7th within one bf16 ulp for a few percent of
# the tokens, so any change of rounding flips some: on an H100 the noise
# probe flips 2.2-9.8 % of serve-mla's and step-mla's routings, the kernels
# 0.01-2.2 points more (110 and 115 of 3718, 973 and 974 of 13806, 5262 and
# 5658 of 53950 in the replays).  There the kernels' flips are held to
# MOE_FLIP_SHARE above the noise probe's in the same replay or step (a
# kernel whose error leans one way still moves many more)
MOE_FLIP_SHARE = 0.05

# deepseek-v2-lite-16b (MLA over MoE: 64 routed experts top-6, 2 shared,
# layer 0 dense).  Its attention on the flash branch takes q and k at head
# dim 192 (128 nope + 64 rope) and v at 128, H = K = 16 (every head over
# the up-projected latent), and its latent norm is K1 at width 512.
# serve-mla: weights drawn leaf by leaf in bf16, as lm.init(dtype=...) does
# (all 27 layers' float32 tree of 62.8 GB beside its cast would not fit),
# CONFIG_SERVE's workload on the gathered path (the latent cache has no
# kv-head axis for K3 or K4).
# train-mla: full width cut to 4 of 27 layers (1 dense, 3 MoE:
# 2,254,983,168 parameters, ~40.6 GB of train state at 18 B a parameter;
# all 27 would be ~283 GB), seq 2048 x batch 2, 4 steps, data seed 2 (seed
# 0's rule x -> 60 x + b mod V shares the factors 2 and 5 of V = 102400 =
# 2^12 5^2, so it runs into a fixed point, as at Griffin's V below)
MLA_HEADS = (16, 16, 192, 128)         # H, K, q/k head dim, v head dim
MLA_RANK = 512
# serve-mla at 5 of 27 layers (the dense first layer and 4 MoE layers):
# the parallel, precompile and dryrun phases' time comes out of the
# gathered path's host-paced ticks, which scale with depth (all 27 fit
# the card: 31.4 GB in bf16)
MLA_SERVE_LAYERS = 5
MLA_SERVE_PARAMS = 2_839_831_040
MLA_TRAIN = dict(seq_len=2048, global_batch=2, steps=4, seed=2)
MLA_TRAIN_LAYERS = 4
MLA_TRAIN_PARAMS = 2_254_983_168

# seamless-m4t-large-v2, the encoder-decoder: 24 encoder and 24 decoder
# layers at d 1024, MHA 16 x 64, GeGLU 8192, layernorm, untied vocab
# 256,206 (2,035,011,584 parameters, as jax.eval_shape of the JAX init
# counts them: 4.07 GB in bf16, ~36.6 GB of train state at 18 B a
# parameter), so it serves and trains at full depth.  Its encoder's
# self-attention and its cross-attention are bidirectional: K2 with causal
# off, the cross-attention's queries over a memory of another length.
# serve-encdec: static serving through the Session, 4 prompts of 2048
# tokens over 2048 source frames each, 32 new tokens.  train-encdec: 2048 x
# 4 on one repeated make_batch batch (frames, target tokens), 4 steps
ENCDEC_HEADS = (16, 16, 64)            # H, K, dh
ENCDEC_PARAMS = 2_035_011_584
ENCDEC_CROSS_T = 1500                  # a memory length apart from the target's
ENCDEC_SERVE = dict(batch=4, prompt_len=2048, max_new=32)
ENCDEC_TRAIN = dict(seq_len=2048, global_batch=4, steps=4, seed=0)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3, graph: bool = False, stream=None) -> float:
    """Mean time of ``fn`` over ``iters`` calls, by CUDA events.  Called
    back to back, a call the device finishes sooner than the host issues it
    is timed at the host's pace; ``graph`` captures the ``iters`` calls in a
    CUDA graph (on ``stream``, if given) and times one replay instead, the
    device's time for them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream, capture_error_mode="relaxed"):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
    else:
        start.record()
        for _ in range(iters):
            fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound(flops: float, nbytes: float,
          flops_per_s: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    t_ops, t_bytes = flops / flops_per_s, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


# ------------------------------------------------------------------ phase 3


QWEN3_HEADS = (40, 8, 128)             # qwen3-14b: H, K, dh (qk_norm)
SMOKE_HEADS = (4, 2, 16)               # the smoke configs' H, K, dh


def make_case(torch, gen, dev, *, S, Q, kv_lens, layers, M=None, qk_norm=False,
              heads=(H, K, DH)):
    """Random bf16 pools with distinct blocks per slot, tables, kv_len, q;
    a slot whose kv_len lies past ``M * BS`` holds ``M`` blocks (its last
    rows are the verify step's pad rows, whose writes go to the null block)."""
    H_, K_, D = heads
    M = M or max(-(-k // BS) for k in kv_lens)
    nb = 1 + sum(-(-k // BS) for k in kv_lens)
    lead = (layers,) if layers else ()
    pools = [torch.randn(lead + (nb, BS, K_, D), generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(2)]
    tables = torch.zeros((S, M), dtype=torch.int32)
    nxt = 1
    for s, kvl in enumerate(kv_lens):
        n = min(-(-kvl // BS), M)  # a slot past its table's reach keeps M blocks
        tables[s, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n
    q = torch.randn((S, Q, H_, D), generator=gen, device=dev).to(torch.bfloat16)
    qn = torch.randn((D,), generator=gen, device=dev) if qk_norm else None
    return dict(q=q, k=pools[0], v=pools[1], tables=tables.to(dev),
                kv_len=torch.tensor(kv_lens, dtype=torch.int32, device=dev),
                q_norm=qn)


def check_kernels(torch, dev) -> dict:
    from repro_torch.kernels.paged_attention import (
        paged_attention_plain, paged_decode_kernel, paged_prefill_kernel,
        paged_prefill_plain_from_raw,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    worst = dict.fromkeys(("paged_decode", "paged_prefill", "paged_decode_dh256",
                           "paged_prefill_verify", "paged_prefill_chunk"), (0.0, 0.0))

    def decode(c, layer, window=None):
        if c.get("q_f32"):
            c = dict(c, q=c["q"].float())
        kw = dict(scale=c["q"].shape[-1] ** -0.5, window=window, layer=layer)
        o = paged_decode_kernel(c["q"], c["k"], c["v"], c["tables"], c["kv_len"], **kw)
        torch.cuda.synchronize()
        ref = paged_attention_plain(c["q"], c["k"], c["v"], c["tables"], c["kv_len"], **kw)
        return _err(o, ref), _row_err(o, ref)

    def prefill(c, layer, q_start, window=None):
        Q = c["q"].shape[1]
        positions = (c["kv_len"].long()[:, None] - Q
                     + torch.arange(Q, device=dev)[None, :])
        kw = dict(scale=c["q"].shape[-1] ** -0.5, window=window, layer=layer,
                  q_norm=c["q_norm"], rope_theta=1e6)
        o = paged_prefill_kernel(c["q"], c["k"], c["v"], c["tables"], c["kv_len"], **kw)
        torch.cuda.synchronize()
        ref = paged_prefill_plain_from_raw(
            c["q"], c["k"], c["v"], c["tables"], c["kv_len"],
            positions=positions, q_start=q_start, **kw)
        return _err(o, ref), _row_err(o, ref)

    def case(**kw):
        return make_case(torch, gen, dev, **kw)

    ragged = [4096, 1, 17, 300, 2048, 1000, 63, 3333]
    # K3 splits the table walk every 128 positions (8 entries of 16); K4
    # walks 64-position kv tiles for 64-query tiles
    cases = [
        ("paged_decode", "Q=1 ragged kv_len<=4096, 5-D pool",
         lambda: decode(case(S=8, Q=1, kv_lens=ragged, layers=3), 2)),
        ("paged_decode", "Q=1 ragged, 4-D pool",
         lambda: decode(case(S=8, Q=1, kv_lens=ragged, layers=0), None)),
        ("paged_decode", "Q=5 ragged, 5-D pool",
         lambda: decode(case(S=8, Q=5, kv_lens=[5, 40, 4096, 777, 16, 33, 2000, 9],
                             layers=2), 1)),
        ("paged_decode", "Q=5 ragged, window 256, 4-D pool",
         lambda: decode(case(S=4, Q=5, kv_lens=[3000, 300, 64, 1025], layers=0),
                        None, window=256)),
        ("paged_decode", "Q=1 kv_len 128/129/256/257/1 at split edges, M=17",
         lambda: decode(case(S=5, Q=1, kv_lens=[128, 129, 256, 257, 1], layers=0,
                             M=17), None)),
        ("paged_decode", "Q=1 window 100 across the split edge 256",
         lambda: decode(case(S=3, Q=1, kv_lens=[300, 260, 356], layers=2, M=23),
                        0, window=100)),
        ("paged_decode", "Q=5 across split edges (kv_len 130/260/5), M=17",
         lambda: decode(case(S=3, Q=5, kv_lens=[130, 260, 5], layers=0, M=17), None)),
        ("paged_decode", "Q=1 serve tick shape, M=132 (16.5 splits)",
         lambda: decode(case(S=8, Q=1, kv_lens=TICK_KV_LENS, layers=2, M=132), 1)),
        ("paged_decode", "Q=5 dh=128 qwen3-14b heads H=40 K=8",
         lambda: decode(case(S=3, Q=5, kv_lens=[129, 700, 2048], layers=0,
                             heads=QWEN3_HEADS), None)),
        ("paged_decode", "Q=1 dh=16 smoke heads H=4 K=2",
         lambda: decode(case(S=3, Q=1, kv_lens=[1, 200, 300], layers=0,
                             heads=SMOKE_HEADS), None)),
        # recurrentgemma-9b's heads: the window's first live position
        # kv_len - 2048 falls before, on and after K3's split edges (127,
        # 128, 129, 256, ...), and every kv_len past 2048 leaves whole splits
        # before the window, which exit at once
        ("paged_decode_dh256", "Q=1 H=16 K=1 window 2048 ragged, 5-D pool",
         lambda: decode(case(S=8, Q=1, kv_lens=[1, 2047, 2048, 2049, 3000, 4096, 129, 2176],
                             layers=3, heads=GRIFFIN_HEADS), 2, window=GRIFFIN_WINDOW)),
        ("paged_decode_dh256", "Q=1 window 2048 edge across split edges, M=200",
         lambda: decode(case(S=5, Q=1, kv_lens=[2175, 2176, 2177, 2304, 2047], layers=0,
                             M=200, heads=GRIFFIN_HEADS), None, window=GRIFFIN_WINDOW)),
        ("paged_decode_dh256", "Q=1 no window, 5-D pool",
         lambda: decode(case(S=4, Q=1, kv_lens=[1, 300, 2100, 3064], layers=2,
                             heads=GRIFFIN_HEADS), 1)),
        ("paged_decode_dh256", "Q=1 float32 queries (a float32 model), window 2048",
         lambda: decode(dict(case(S=4, Q=1, kv_lens=[100, 2049, 2176, 3064], layers=2,
                                  heads=GRIFFIN_HEADS), q_f32=True), 1,
                        window=GRIFFIN_WINDOW)),
        ("paged_prefill", "P=128 q_start=0, 5-D pool",
         lambda: prefill(case(S=1, Q=128, kv_lens=[128], layers=2), 1, 0)),
        ("paged_prefill", "P=2048 q_start=0, 5-D pool",
         lambda: prefill(case(S=1, Q=2048, kv_lens=[2048], layers=2), 0, 0)),
        ("paged_prefill", "Q=128 mid-sequence start (kv_len 828), 4-D pool",
         lambda: prefill(case(S=1, Q=128, kv_lens=[828], layers=0), None, None)),
        ("paged_prefill", "P=512 window 128, 4-D pool",
         lambda: prefill(case(S=1, Q=512, kv_lens=[512], layers=0), None, 0,
                         window=128)),
        ("paged_prefill", "P=128 random q_norm, 2 slots, 5-D pool",
         lambda: prefill(case(S=2, Q=128, kv_lens=[128, 400], layers=2, qk_norm=True),
                         1, None)),
        ("paged_prefill", "P=100, not a multiple of 64",
         lambda: prefill(case(S=1, Q=100, kv_lens=[100], layers=0), None, 0)),
        ("paged_prefill", "Q=65 mid-sequence (kv_len 1000), window 300",
         lambda: prefill(case(S=1, Q=65, kv_lens=[1000], layers=0), None, None,
                         window=300)),
        ("paged_prefill", "P=1000 q_norm dh=128 qwen3-14b heads H=40 K=8",
         lambda: prefill(case(S=1, Q=1000, kv_lens=[1000], layers=0, qk_norm=True,
                              heads=QWEN3_HEADS), None, 0)),
        ("paged_prefill", "Q=77 dh=16 smoke heads H=4 K=2, 2 slots (kv 77, 200)",
         lambda: prefill(case(S=2, Q=77, kv_lens=[77, 200], layers=0,
                              heads=SMOKE_HEADS), None, None)),
        # the served regimes over a cached prefix (no q_start): the
        # speculative verify step, Q = SPEC_K + 1 over 8 ragged slots, one
        # slot's last 3 rows past its 132-entry table (pad rows), and the
        # chunked prefill's chunks of 32 and 256 at block-aligned starts
        ("paged_prefill_verify", "S=8 Q=5 kv_len 140-2115 (3 rows past M=132), 5-D",
         lambda: prefill(case(S=8, Q=SPEC_K + 1, kv_lens=VERIFY_PAD_KV_LENS,
                              layers=3, M=132), 2, None)),
        ("paged_prefill_verify", "S=8 Q=5 kv_len TICK_KV_LENS, 4-D pool",
         lambda: prefill(case(S=8, Q=SPEC_K + 1, kv_lens=TICK_KV_LENS, layers=0,
                              M=132), None, None)),
        ("paged_prefill_chunk", "S=1 Q=32 chunks at kv_len 32, 544, 2048, 5-D",
         lambda: tuple(map(max, *(prefill(case(S=1, Q=CHUNK, kv_lens=[n], layers=2),
                                          1, None) for n in (32, 544, 2048))))),
        ("paged_prefill_chunk", "S=1 Q=256 chunks at kv_len 256, 1024, 2048, 4-D",
         lambda: tuple(map(max, *(prefill(case(S=1, Q=256, kv_lens=[n], layers=0),
                                          None, None) for n in (256, 1024, 2048))))),
        # the served heads of minitron-4b (G = 3), minicpm-2b (MHA, G = 1)
        # and phi3.5-moe (G = 4): a tick, split edges, prompts, a verify
        # step and a chunk
        ("paged_decode", "Q=1 minitron H=24 K=8 dh=128 tick shape, M=132",
         lambda: decode(case(S=8, Q=1, kv_lens=TICK_KV_LENS, layers=2, M=132,
                             heads=MINITRON_HEADS), 1)),
        ("paged_decode", "Q=1 minicpm H=36 K=36 dh=64 ragged kv_len<=4096",
         lambda: decode(case(S=8, Q=1, kv_lens=ragged, layers=2, heads=MINICPM_HEADS), 0)),
        ("paged_decode", "Q=5 minicpm H=36 K=36 across split edges, M=17",
         lambda: decode(case(S=3, Q=5, kv_lens=[130, 260, 5], layers=0, M=17,
                             heads=MINICPM_HEADS), None)),
        ("paged_decode", "Q=1 phi3.5-moe H=32 K=8 dh=128 split edges, M=17",
         lambda: decode(case(S=5, Q=1, kv_lens=[128, 129, 256, 257, 1], layers=0,
                             M=17, heads=PHI_HEADS), None)),
        ("paged_decode", "Q=5 phi3.5-moe H=32 K=8 ragged, 5-D pool",
         lambda: decode(case(S=8, Q=5, kv_lens=[5, 40, 4096, 777, 16, 33, 2000, 9],
                             layers=2, heads=PHI_HEADS), 1)),
        ("paged_prefill", "P=2048 minitron H=24 K=8 dh=128, 5-D pool",
         lambda: prefill(case(S=1, Q=2048, kv_lens=[2048], layers=2,
                              heads=MINITRON_HEADS), 1, 0)),
        ("paged_prefill", "P=512 minicpm H=36 K=36 dh=64, 4-D pool",
         lambda: prefill(case(S=1, Q=512, kv_lens=[512], layers=0,
                              heads=MINICPM_HEADS), None, 0)),
        ("paged_prefill", "Q=100 minicpm, 2 slots (kv 100, 1000), not x64",
         lambda: prefill(case(S=2, Q=100, kv_lens=[100, 1000], layers=0,
                              heads=MINICPM_HEADS), None, None)),
        ("paged_prefill", "P=2048 phi3.5-moe H=32 K=8 dh=128, 5-D pool",
         lambda: prefill(case(S=1, Q=2048, kv_lens=[2048], layers=2,
                              heads=PHI_HEADS), 0, 0)),
        ("paged_prefill_verify", "S=8 Q=5 minitron G=3 kv_len TICK_KV_LENS",
         lambda: prefill(case(S=8, Q=SPEC_K + 1, kv_lens=VERIFY_PAD_KV_LENS, layers=2,
                              M=132, heads=MINITRON_HEADS), 1, None)),
        ("paged_prefill_chunk", "S=1 Q=32 minicpm G=1 at kv_len 544, 2048",
         lambda: tuple(map(max, *(prefill(case(S=1, Q=CHUNK, kv_lens=[n], layers=0,
                                               heads=MINICPM_HEADS), None, None)
                                  for n in (544, 2048))))),
    ]
    for name, what, run in cases:
        abs_err, row_err = run()
        ok = row_err <= FLASH_ROW_RTOL
        log(f"[kernels] {name:18s} {what:52s} row_err={row_err:.3e} "
            f"abs_err={abs_err:.3e} tol={FLASH_ROW_RTOL:.2e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: {what}")
        worst[name] = tuple(map(max, worst[name], (abs_err, row_err)))
    return worst


def time_kernels(torch, dev, worst: dict) -> dict:
    """Kernel, plain and library times at the main path's shapes: K3 at one
    tick of the serve phase's shape (``TICK_KV_LENS``, table width 132, the
    workload's worst request) and K4 at its longest prompt, over the
    24-layer pool; K3 at a Griffin tick; K4 at a verify step and a chunk."""
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for key, row in (
            ("paged_decode", _time_decode_tick(torch, gen, dev, heads=(H, K, DH),
                                               kv_lens=TICK_KV_LENS, M=132, n_layers=24)),
            ("paged_prefill", _time_prompt(torch, gen, dev, heads=(H, K, DH), n_layers=24,
                                           rope_theta=1e6, iters=24, graph=False)),
            ("paged_decode_dh256", _time_decode_tick(
                torch, gen, dev, heads=GRIFFIN_HEADS, kv_lens=GRIFFIN_TICK_KV_LENS,
                M=GRIFFIN_TICK_M, n_layers=12, window=GRIFFIN_WINDOW))):
        out[key] = dict(row, max_abs_err=worst[key][0], max_row_err=worst[key][1],
                        tolerance=FLASH_ROW_RTOL)
    out.update(_time_prefill_served(torch, gen, dev, worst))
    return out


def _dense_kv(torch, c, kv_lens, heads, dev):
    """Layer 0's K and V of ``c``'s pool gathered into dense ``[S, H, T,
    dh]`` views (kv heads repeated to the query heads, zeros past each
    kv_len): SDPA's inputs, gathered outside its timing."""
    H_, K_, D = heads
    kd = torch.zeros((len(kv_lens), H_, max(kv_lens), D), dtype=torch.bfloat16, device=dev)
    vd = torch.zeros_like(kd)
    for s, n in enumerate(kv_lens):
        blocks = c["tables"][s, : -(-n // BS)].long()
        for src, dst in ((c["k"][0], kd), (c["v"][0], vd)):
            dense = src[blocks].reshape(-1, K_, D)[:n]           # [n, K, dh]
            dst[s, :, :n] = dense.permute(1, 0, 2).repeat_interleave(H_ // K_, 0)
    return kd, vd


def _time_decode_tick(torch, gen, dev, *, heads, kv_lens, M: int, n_layers: int,
                      window: int | None = None, label: str = "") -> dict:
    """K3 at one decode tick: a slot a ``kv_lens`` entry, table width ``M``,
    over an ``n_layers``-layer pool (successive launches walk successive
    layers, so the working set exceeds the 50 MB L2).  The device takes less
    time for K3 (and SDPA) than the host for a call's wrapper, so the
    kernel and SDPA (over :func:`_dense_kv`, kv_len and ``window`` as a
    mask) are timed through CUDA graphs of back-to-back calls, with the
    host-paced times logged beside; the plain version host-paced.
    ``bound_ms`` moves the live K/V (the window's positions a slot) once."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import paged_attention_plain, paged_decode_kernel

    H_, K_, D = heads
    S = len(kv_lens)
    c = make_case(torch, gen, dev, S=S, Q=1, kv_lens=kv_lens, layers=n_layers, M=M,
                  heads=heads)
    args = (c["q"], c["k"], c["v"], c["tables"], c["kv_len"])
    scale = D ** -0.5
    layer = iter(range(10 ** 9))
    kw = lambda: dict(scale=scale, window=window, layer=next(layer) % n_layers)  # noqa: E731
    iters = 4 * n_layers
    ms = cuda_ms(lambda: paged_decode_kernel(*args, **kw()), iters, graph=True)
    paced = cuda_ms(lambda: paged_decode_kernel(*args, **kw()), iters)
    plain = cuda_ms(lambda: paged_attention_plain(*args, **kw()), n_layers)
    kd, vd = _dense_kv(torch, c, kv_lens, heads, dev)
    pos = torch.arange(max(kv_lens), device=dev)[None, :]
    kvl = c["kv_len"][:, None]
    mask = (pos < kvl) & (pos >= kvl - window) if window else pos < kvl
    mask = mask.reshape(S, 1, 1, -1)
    qd = c["q"].permute(0, 2, 1, 3)                               # [S, H, 1, dh]

    def sdpa():
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask, scale=scale)

    lib, lib_paced = cuda_ms(sdpa, iters, graph=True), cuda_ms(sdpa, iters)
    live = sum(min(n, window) if window else n for n in kv_lens)
    nbytes = 2 * (2 * S * H_ * D) + 2 * 2 * live * K_ * D + 4 * (S * M + S)
    b_ms, b_by = bound(4 * live * H_ * D, nbytes)
    log(f"[timing] paged_decode  {label}H={H_} K={K_} dh={D} (G={H_ // K_}) S={S} Q=1 "
        f"kv_len={kv_lens}{f' window {window}' if window else ''} M={M} {n_layers}-layer "
        f"pool: kernel_ms={ms:.4f} (graph; host-paced {paced:.4f}) plain_ms={plain:.4f} "
        f"library_ms={lib:.4f} (SDPA, graph; host-paced {lib_paced:.4f}) "
        f"bound_ms={b_ms:.6f} ({b_by})")
    del c, args, kd, vd
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def _time_prompt(torch, gen, dev, *, heads, n_layers: int, rope_theta: float, iters: int,
                 graph: bool, label: str = "") -> dict:
    """K4 at the workloads' longest prompt, P = 2048 from position 0, over
    an ``n_layers``-layer pool (successive launches walk successive layers);
    kernel and causal SDPA (over the dense view, gathered beforehand)
    ``iters`` calls, through CUDA graphs with ``graph``; the plain version
    host-paced.  ``bound_ms`` counts the causal pairs."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import (
        paged_prefill_kernel, paged_prefill_plain_from_raw)

    H_, K_, D = heads
    P = 2048
    c = make_case(torch, gen, dev, S=1, Q=P, kv_lens=[P], layers=n_layers, heads=heads)
    args = (c["q"], c["k"], c["v"], c["tables"], c["kv_len"])
    positions = torch.arange(P, device=dev)[None, :]
    scale = D ** -0.5
    layer = iter(range(10 ** 9))
    kw = lambda: dict(scale=scale, rope_theta=rope_theta,  # noqa: E731
                      layer=next(layer) % n_layers)
    ms = cuda_ms(lambda: paged_prefill_kernel(*args, **kw()), iters, graph=graph)
    plain = cuda_ms(lambda: paged_prefill_plain_from_raw(
        *args, positions=positions, q_start=0, **kw()), max(3, n_layers // 4), warmup=1)
    kd, vd = _dense_kv(torch, c, [P], heads, dev)
    qd = c["q"].permute(0, 2, 1, 3).contiguous()
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, is_causal=True, scale=scale), iters, graph=graph)
    b_ms, b_by = bound(4 * (P * (P + 1) // 2) * H_ * D,
                       2 * (2 * P * H_ * D) + 2 * 2 * P * K_ * D + 4 * (P // BS + 1))
    log(f"[timing] paged_prefill {label}H={H_} K={K_} dh={D} (G={H_ // K_}) P={P} "
        f"q_start=0 {n_layers}-layer pool: kernel_ms={ms:.4f}{' (graph)' if graph else ''} "
        f"plain_ms={plain:.4f} library_ms={lib:.4f} (SDPA causal"
        f"{', graph' if graph else ''}) bound_ms={b_ms:.6f} ({b_by})")
    del c, args, kd, vd
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def _time_prefill_served(torch, gen, dev, worst: dict) -> dict:
    """K4 at the serve_paths phase's shapes: one verify step (8 slots, Q =
    SPEC_K + 1, kv_len ``TICK_KV_LENS``, table width 132) over the 24-layer
    pool, and the last 32-token chunk of a 2048-token prompt (kv_len 2048)
    over a 96-layer pool (24 layers' K/V of one slot fit the 50 MB L2, where
    a served chunk finds them cold); successive launches walk successive
    layers.  Kernel and SDPA (over :func:`_dense_kv`, each query row masked
    at its limit ``kv_len - (Q - 1 - i)``) through CUDA graphs; the plain
    version host-paced.  ``bound_ms`` reads q and the live K/V once, writes
    the output, and counts each row's visible keys."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import (
        paged_prefill_kernel, paged_prefill_plain_from_raw)

    scale = DH ** -0.5
    out = {}
    layer = iter(range(10 ** 9))
    for key, S, Q, kv_lens, M, n_layers in (
            ("paged_prefill_verify", 8, SPEC_K + 1, TICK_KV_LENS, 132, 24),
            ("paged_prefill_chunk", 1, CHUNK, [2048], 128, 96)):
        c = make_case(torch, gen, dev, S=S, Q=Q, kv_lens=kv_lens, layers=n_layers, M=M)
        args = (c["q"], c["k"], c["v"], c["tables"], c["kv_len"])
        positions = (c["kv_len"].long()[:, None] - Q
                     + torch.arange(Q, device=dev)[None, :])
        kw = dict(scale=scale, rope_theta=1e6)
        ms = cuda_ms(lambda: paged_prefill_kernel(*args, layer=next(layer) % n_layers,
                                                  **kw), 96, graph=True)
        paced = cuda_ms(lambda: paged_prefill_kernel(*args, layer=next(layer) % n_layers,
                                                     **kw), 96)
        plain = cuda_ms(lambda: paged_prefill_plain_from_raw(
            *args, positions=positions, layer=next(layer) % n_layers, **kw), 12)
        T = max(kv_lens)
        kd, vd = _dense_kv(torch, c, kv_lens, (H, K, DH), dev)
        limit = c["kv_len"][:, None] - (Q - 1) + torch.arange(Q, device=dev)[None, :]
        mask = (torch.arange(T, device=dev)[None, None, :] < limit[:, :, None])[:, None]
        qd = c["q"].permute(0, 2, 1, 3).contiguous()             # [S, H, Q, dh]

        def sdpa():
            return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                                  scale=scale)

        lib = cuda_ms(sdpa, 96, graph=True)
        keys = int(limit.clamp(min=0).sum())
        nbytes = (2 * (2 * S * Q * H * DH) + 2 * 2 * sum(kv_lens) * K * DH
                  + 4 * (S * M + S))
        b_ms, b_by = bound(4 * keys * H * DH, nbytes)
        out[key] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                        bound_by=b_by, max_abs_err=worst[key][0],
                        max_row_err=worst[key][1], tolerance=FLASH_ROW_RTOL)
        log(f"[timing] {key} S={S} Q={Q} kv_len={kv_lens} M={M} {n_layers}-layer "
            f"pool: kernel_ms={ms:.4f} (graph; host-paced {paced:.4f}) "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} (graph) "
            f"bound_ms={b_ms:.6f} ({b_by})")
    return out


def time_config_kernels(torch, dev, worst: dict) -> None:
    """The kernels at the shapes the dense configs give them: K3 and K4 at
    minitron-4b's and minicpm-2b's heads over 8-layer pools, K2 forward and
    backward at qwen2-vl-7b's and minicpm-2b's training shapes, K1 forward
    and backward at widths 2304, 3072 and 3584; each beside its plain
    version, its library yardstick and its bound.  Logged only (the summary
    line keeps one row a kernel, at qwen2-0.5b's shapes)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    for name, heads in (("minitron", MINITRON_HEADS), ("minicpm", MINICPM_HEADS)):
        _time_decode_tick(torch, gen, dev, heads=heads, kv_lens=TICK_KV_LENS, M=132,
                          n_layers=8, label=f"{name} ")
        _time_prompt(torch, gen, dev, heads=heads, n_layers=8, rope_theta=1e4, iters=16,
                     graph=True, label=f"{name} ")
        torch.cuda.empty_cache()
    for D in (MINICPM_D, MINITRON_D, QWEN2VL_D):
        _time_norm(torch, gen, dev, 8192, D)
    _time_flash(torch, gen, dev, worst, 4, 2048, *QWEN2VL_HEADS, None, "_qwen2vl")
    _time_flash(torch, gen, dev, worst, 4, 2048, *MINICPM_HEADS, None, "_minicpm")
    torch.cuda.empty_cache()


def time_mla_kernels(torch, dev, worst: dict) -> dict:
    """K2 at deepseek-v2-lite's training shape (B 2, S 2048, H = K = 16, q/k
    at 192, v at 128; rows ``flash_fwd_mla`` and ``flash_bwd_mla``) and K1
    at the latent's width 512 (logged): kernel, plain version, library
    yardstick and bound."""
    gen = torch.Generator(device=dev).manual_seed(5)
    B, S = MLA_TRAIN["global_batch"], MLA_TRAIN["seq_len"]
    _time_norm(torch, gen, dev, B * S, MLA_RANK)
    Hm, Km, Dm, Dvm = MLA_HEADS
    out = _time_flash(torch, gen, dev, worst, B, S, Hm, Km, Dm, None, "_mla", Dv=Dvm)
    torch.cuda.empty_cache()
    return out


def time_encdec_kernels(torch, dev, worst: dict) -> dict:
    """K2 at seamless-m4t's training shape, bidirectional (B 4, S = T 2048,
    H = K = 16, dh 64; rows ``flash_fwd_encdec`` and ``flash_bwd_encdec``):
    kernel, plain version, SDPA (``is_causal=False``) and bound."""
    gen = torch.Generator(device=dev).manual_seed(6)
    out = _time_flash(torch, gen, dev, worst, ENCDEC_TRAIN["global_batch"],
                      ENCDEC_TRAIN["seq_len"], *ENCDEC_HEADS, None, "_encdec",
                      causal=False)
    torch.cuda.empty_cache()
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


def _flash_inputs(torch, gen, dev, B, S, T, H_, K_, D, Dv=None):
    """q, k, v and dO in bf16; v and dO at ``Dv`` columns (default ``D``)."""
    Dv = D if Dv is None else Dv

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    return r(B, S, H_, D), r(B, T, K_, D), r(B, T, K_, Dv), r(B, S, H_, Dv)


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
    worst.update(dict.fromkeys(("flash_fwd", "flash_bwd", "flash_fwd_dh256",
                                "flash_bwd_dh256", "flash_fwd_qwen2vl",
                                "flash_bwd_qwen2vl", "flash_fwd_minicpm",
                                "flash_bwd_minicpm", "flash_fwd_mla",
                                "flash_bwd_mla", "flash_fwd_encdec",
                                "flash_bwd_encdec"), (0.0, 0.0)))

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

    def flash(B, S, T, H_, K_, D, causal, window, what, key="", twice=False, Dv=None):
        q, k, v, do = _flash_inputs(torch, gen, dev, B, S, T, H_, K_, D, Dv)
        kw = dict(scale=D ** -0.5, causal=causal, window=window)
        o, lse = flash_fwd_kernel(q, k, v, **kw)
        grads = flash_bwd_kernel(q, k, v, o, lse, do, **kw)
        if twice:  # no float atomics: a second run is bit-identical
            again = flash_bwd_kernel(q, k, v, o, lse, do, **kw)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f"flash backward differs between runs: {what}")
            log(f"[kernels] flash         {what:50s} backward bit-identical on a second run")
            del again
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
        record_flash(f"flash_fwd{key}", a_o, r_o)
        record_flash(f"flash_bwd{key}", a_g, max(r_g.values()))

    norm(NORM_ROWS, D_MODEL, torch.bfloat16, f"[{NORM_ROWS}, {D_MODEL}] bf16, bf16 scale")
    norm(8 * 2048 * 40, 128, torch.bfloat16, "[B*S*H=655360, 128] qwen3 qk_norm shape")
    norm(16383, D_MODEL, torch.float32, f"[16383, {D_MODEL}] odd rows, f32 scale")
    norm(RWKV_TRAIN["seq_len"] * RWKV_TRAIN["global_batch"], RWKV_D, torch.bfloat16,
         f"[8192, {RWKV_D}] rwkv6-3b width, bf16 scale")
    norm(GRIFFIN_TRAIN["seq_len"] * GRIFFIN_TRAIN["global_batch"], GRIFFIN_W,
         torch.bfloat16, f"[8192, {GRIFFIN_W}] recurrentgemma-9b width, bf16 scale")
    flash(8, 2048, 2048, H, K, DH, True, None, "B=8 S=T=2048 H=14 K=2 dh=64 causal",
          twice=True)
    # a tensor rank's share of qwen2-0.5b's heads at tp 2 (G = 7)
    B, S = PAR_SHAPE["global_batch"], PAR_SHAPE["seq_len"]
    flash(B, S, S, H // 2, K // 2, DH, True, None,
          f"B={B} S=T={S} H=7 K=1 dh=64 causal (tp 2)", twice=True)
    flash(2, 300, 300, H, K, DH, True, 100, "B=2 S=T=300 window 100")
    flash(2, 200, 333, 4, 2, 128, False, None, "B=2 S=200 T=333 bidirectional dh=128")
    flash(1, 77, 77, 8, 8, 64, True, None, "B=1 S=T=77 MHA causal")
    # the tiles' edges: 128-row query blocks (forward, dq), 128-key tiles and
    # dk/dv blocks (64 at dh 256), 64-row steps; dh 16 and 32 in one
    # zero-padded 64-column chunk
    flash(1, 129, 127, H, K, DH, True, None, "B=1 S=129 T=127 causal (tile edges)")
    flash(2, 257, 257, 4, 1, 128, True, 40, "B=2 S=T=257 dh=128 window 40 < a tile")
    flash(1, 300, 300, H, K, 16, True, 100, "B=1 S=T=300 dh=16 window ends mid-tile")
    flash(1, 100, 60, 2, 1, 32, False, 10, "B=1 S=100 T=60 dh=32 bidir. window 10")
    # Griffin's attention: head dim 256, MQA, window 2048 (its own rows)
    B, S, W = GRIFFIN_TRAIN["global_batch"], GRIFFIN_TRAIN["seq_len"], GRIFFIN_WINDOW
    flash(B, S, S, GRIFFIN_H, 1, GRIFFIN_DH, True, W,
          f"B={B} S=T={S} H=16 K=1 dh=256 window {W}", "_dh256")
    flash(1, 1000, 1000, GRIFFIN_H, 1, GRIFFIN_DH, True, W,
          f"B=1 S=T=1000 H=16 K=1 dh=256 window {W} > S", "_dh256")
    flash(1, 193, 193, GRIFFIN_H, 1, GRIFFIN_DH, True, 40,
          "B=1 S=T=193 H=16 K=1 dh=256 window 40 (tile edges)", "_dh256", twice=True)
    # the dense configs' and phi3.5-moe's training shapes (qwen2-vl G = 7 at
    # dh 128, minicpm MHA at dh 64, phi3.5-moe G = 4) and K1 at their widths
    for D in (MINICPM_D, MINITRON_D, QWEN2VL_D):
        norm(8192, D, torch.bfloat16, f"[8192, {D}] bf16 scale (BLOCK_D 4096 masked)")
    flash(4, 2048, 2048, *QWEN2VL_HEADS, True, None,
          "B=4 S=T=2048 H=28 K=4 dh=128 causal (qwen2-vl)", "_qwen2vl")
    flash(4, 2048, 2048, *MINICPM_HEADS, True, None,
          "B=4 S=T=2048 H=36 K=36 dh=64 causal (minicpm)", "_minicpm", twice=True)
    flash(2, 2048, 2048, *PHI_HEADS, True, None,
          "B=2 S=T=2048 H=32 K=8 dh=128 causal (phi3.5-moe)")
    flash(1, 300, 300, *MINICPM_HEADS, True, None, "B=1 S=T=300 minicpm (tile edges)",
          "_minicpm")
    # MLA: v's head dim apart from q's, deepseek-v2-lite's (192, 128) at its
    # training shape and across the tiles' edges (128-query blocks, 128-key
    # forward tiles in a two-stage ring, 64-key dk/dv blocks whose two
    # warpgroups own dK and dV), the smoke config's (24, 16) in one
    # zero-filled chunk each; K1 at the latent's width 512 (bf16 scale when
    # training, float32 when serving)
    Hm, Km, Dm, Dvm = MLA_HEADS
    B, S = MLA_TRAIN["global_batch"], MLA_TRAIN["seq_len"]
    flash(B, S, S, Hm, Km, Dm, True, None,
          f"B={B} S=T={S} H=K=16 dh=192/128 causal (deepseek)", "_mla", twice=True, Dv=Dvm)
    flash(1, 129, 127, Hm, Km, Dm, True, None, "B=1 S=129 T=127 dh=192/128 (tile edges)",
          "_mla", Dv=Dvm)
    flash(1, 300, 300, Hm, Km, Dm, True, None, "B=1 S=T=300 dh=192/128 (tile edges)",
          "_mla", Dv=Dvm)
    flash(2, 300, 300, 4, 2, Dm, True, 100, "B=2 S=T=300 G=2 dh=192/128 window 100",
          "_mla", twice=True, Dv=Dvm)
    flash(1, 200, 333, 4, 4, Dm, False, None, "B=1 S=200 T=333 dh=192/128 bidirectional",
          "_mla", Dv=Dvm)
    flash(2, 300, 300, 4, 4, 24, True, None, "B=2 S=T=300 dh=24/16 causal (smoke)",
          twice=True, Dv=16)
    flash(1, 129, 127, 4, 2, 24, True, None, "B=1 S=129 T=127 dh=24/16 (tile edges)", Dv=16)
    flash(1, 300, 300, 4, 1, 24, True, 40, "B=1 S=T=300 dh=24/16 window 40", Dv=16)
    norm(S * B, MLA_RANK, torch.bfloat16, f"[{S * B}, {MLA_RANK}] MLA latent, bf16 scale")
    norm(2048, MLA_RANK, torch.float32, f"[2048, {MLA_RANK}] MLA latent, f32 scale")
    # seamless-m4t: bidirectional at MHA 16 x 64, the encoder's
    # self-attention at its training shape (every kv tile whole, taken
    # unmasked), the cross-attention over a memory of another length, and
    # the tiles' edges (one query past a block, one key short of a tile)
    B, S = ENCDEC_TRAIN["global_batch"], ENCDEC_TRAIN["seq_len"]
    flash(B, S, S, *ENCDEC_HEADS, False, None,
          f"B={B} S=T={S} H=K=16 dh=64 bidirectional (seamless)", "_encdec", twice=True)
    flash(B, S, ENCDEC_CROSS_T, *ENCDEC_HEADS, False, None,
          f"B={B} S={S} T={ENCDEC_CROSS_T} H=K=16 bidirectional (cross)", "_encdec")
    flash(1, 129, 2047, *ENCDEC_HEADS, False, None,
          "B=1 S=129 T=2047 H=K=16 bidirectional (tile edges)", "_encdec")
    return worst


def time_training_kernels(torch, dev, worst: dict) -> dict:
    """K1 and K2 (head dims 64 and 256): kernel, plain and library times at
    the train paths' shapes; K1's rows are qwen2-0.5b's, the other widths
    are logged."""
    gen = torch.Generator(device=dev).manual_seed(3)
    out = _time_norm(torch, gen, dev, NORM_ROWS, D_MODEL)
    for name, t in out.items():
        t.update(max_abs_err=worst[name][0], tolerance=worst[name][1])
    for shape, width in ((RWKV_TRAIN, RWKV_D), (GRIFFIN_TRAIN, GRIFFIN_W)):
        _time_norm(torch, gen, dev, shape["seq_len"] * shape["global_batch"], width)
    out.update(_time_flash(torch, gen, dev, worst, TRAIN["global_batch"],
                           TRAIN["seq_len"], H, K, DH, None, ""))
    out.update(_time_flash(torch, gen, dev, worst, GRIFFIN_TRAIN["global_batch"],
                           GRIFFIN_TRAIN["seq_len"], GRIFFIN_H, 1, GRIFFIN_DH,
                           GRIFFIN_WINDOW, "_dh256"))
    return out


def _time_norm(torch, gen, dev, N: int, D: int) -> dict:
    """K1 at ``[N, D]`` bf16 with a bf16 scale: kernel, plain and library
    (``F.rms_norm``; its backward alone for the backward row: ``autograd.grad``
    from one kept forward) times and bounds, rows ``rmsnorm_fwd`` and
    ``rmsnorm_bwd``.  Kernel and library are timed on the device, through a
    CUDA graph: back to back, a Triton launch costs the host more than the
    kernel takes the card, so those times are the host's (logged beside,
    labelled host-paced, with ``F.rms_norm``'s forward plus backward)."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import (
        rmsnorm_bwd_kernel, rmsnorm_bwd_plain, rmsnorm_fwd_kernel, rmsnorm_plain)

    x = torch.randn((N, D), generator=gen, device=dev).bfloat16()
    sc = (1 + 0.3 * torch.randn((D,), generator=gen, device=dev)).bfloat16()
    dy = torch.randn((N, D), generator=gen, device=dev).bfloat16()
    _, rstd = rmsnorm_fwd_kernel(x, sc, 1e-6)
    xl = x.clone().requires_grad_(True)
    sl = sc.clone().requires_grad_(True)
    # the kept forward runs on the stream its backward is captured on (a
    # backward runs on its forward's stream)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        y_lib = F.rms_norm(xl, (D,), weight=sl, eps=1e-6)
    torch.cuda.synchronize()

    def lib_norm_bwd():
        torch.autograd.grad(y_lib, (xl, sl), dy, retain_graph=True)

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
                        lib_norm_bwd,
                        bound(0, 3 * 2 * N * D + 4 * N + 2 * 2 * D)),
    }
    out = {}
    for name, (kern, plain, lib, (b_ms, b_by)) in rows.items():
        out[name] = t = dict(
            ms=cuda_ms(kern, 50, graph=True), plain_ms=cuda_ms(plain, 20),
            library_ms=cuda_ms(lib, 50, graph=True, stream=side), bound_ms=b_ms,
            bound_by=b_by)
        lib_name = "F.rms_norm" + (" bwd alone" if name.endswith("bwd") else "")
        host = (f"host-paced: kernel_ms={cuda_ms(kern, 50):.4f} "
                f"{lib_name} {cuda_ms(lib, 50):.4f}")
        if name.endswith("bwd"):
            host += f"; F.rms_norm fwd+bwd {cuda_ms(lib_norm_fb, 50):.4f}"
        log(f"[timing] {name:13s} [{N}, {D}] bf16 (CUDA graph): kernel_ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} ({lib_name}) "
            f"bound_ms={b_ms:.6f} ({b_by}); {host}")
    return out


def _time_flash(torch, gen, dev, worst, B, S, H_, K_, D, window, key, Dv=None,
                causal: bool = True) -> dict:
    """K2 at one training shape, causal or (``causal=False``, no window)
    bidirectional, v's head dim ``Dv`` (default ``D``): kernel, plain and
    library times, rows ``flash_fwd{key}`` and ``flash_bwd{key}``.  The library yardstick is SDPA; a window enters it as
    a boolean mask, with the kv heads expanded to the query heads beforehand
    (not timed).  The backward row's yardstick is SDPA's backward alone
    (``autograd.grad`` from one kept forward); its forward plus backward is
    logged beside it.  Where ``Dv`` differs from ``D``, the SDPA backends
    that take the call and the kernels the default one runs are logged.
    The bound's operations count each product at its own width: 2 (D + Dv)
    flops a query-key pair forward, 2 (3 D + 2 Dv) backward; a
    bidirectional call sees all S x S pairs."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_bwd_kernel, flash_bwd_plain, flash_fwd_kernel, flash_fwd_plain)
    from repro_torch.kernels.flash_attention.ref import visible

    Dv = D if Dv is None else Dv
    q, k, v, do = _flash_inputs(torch, gen, dev, B, S, S, H_, K_, D, Dv)
    kw = dict(scale=D ** -0.5, causal=causal, window=window)
    o, lse = flash_fwd_kernel(q, k, v, **kw)
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    if window is None:
        kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (k, v))
        lib_kw = dict(is_causal=causal, enable_gqa=True)
    else:
        kt, vt = (t.transpose(1, 2).repeat_interleave(H_ // K_, 1).contiguous()
                  .requires_grad_(True) for t in (k, v))
        lib_kw = dict(attn_mask=visible(S, S, True, window, dev))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, scale=D ** -0.5, **lib_kw)

    def sdpa_fb():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    out_lib = sdpa()

    def sdpa_bwd():  # SDPA's backward alone, from one forward kept alive
        torch.autograd.grad(out_lib, (qt, kt, vt), dot, retain_graph=True)

    if Dv != D:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        takes = []
        for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                   SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            try:
                with sdpa_kernel(be):
                    torch.autograd.grad(sdpa(), (qt, kt, vt), dot)
                torch.cuda.synchronize()
                takes.append(be.name)
            except RuntimeError:
                pass
        log(f"[timing] SDPA at q/k dh {D}, v dh {Dv}: backends that take it {takes}; "
            "the default's kernels: "
            + ", ".join(f"{n} {ms:.4f} ms" for n, ms in _kernel_split(torch, sdpa_fb)))

    pairs = B * H_ * (_window_pairs(S, window or S) if causal else S * S)
    io_bytes = 2 * (B * S * H_ * (D + Dv) + B * S * K_ * (D + Dv))
    rows = {
        f"flash_fwd{key}": (lambda: flash_fwd_kernel(q, k, v, **kw),
                            lambda: flash_fwd_plain(q, k, v, **kw), sdpa,
                            bound(2 * (D + Dv) * pairs, io_bytes + 4 * B * H_ * S)),
        f"flash_bwd{key}": (lambda: flash_bwd_kernel(q, k, v, o, lse, do, **kw),
                            lambda: flash_bwd_plain(q, k, v, o, lse, do, **kw), sdpa_bwd,
                            bound(2 * (3 * D + 2 * Dv) * pairs,
                                  2 * io_bytes + 4 * B * H_ * S)),
    }
    out = {}
    what = f"B={B} S=T={S} H={H_} K={K_} dh={D}{f'/{Dv}' if Dv != D else ''} " + (
        f"window {window}" if window else "causal" if causal else "bidirectional")
    for name, (kern, plain, lib, (b_ms, b_by)) in rows.items():
        out[name] = t = dict(
            ms=cuda_ms(kern, 10), plain_ms=cuda_ms(plain, 3, warmup=1),
            library_ms=cuda_ms(lib, 20), bound_ms=b_ms, bound_by=b_by,
            max_abs_err=worst[name][0], max_row_err=worst[name][1],
            tolerance=FLASH_ROW_RTOL)
        lib_name = "SDPA"
        if name.startswith("flash_bwd"):
            log(f"[timing] {name:15s} its kernels (torch.profiler, one call): "
                + ", ".join(f"{k} {ms:.4f} ms" for k, ms in _kernel_split(torch, kern)))
            fb_ms = cuda_ms(sdpa_fb, 20)
            lib_name = f"SDPA bwd alone; SDPA fwd+bwd {fb_ms:.4f}"
        torch.cuda.empty_cache()
        log(f"[timing] {name:15s} {what}: kernel_ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
            f"({lib_name}) bound_ms={b_ms:.6f} ({b_by})")
    return out


def _kernel_split(torch, fn) -> list[tuple[str, float]]:
    """Device ms of each kernel one call of ``fn`` launches, by name (the
    name cut at its template arguments), under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0].split("::")[-1].split()[-1]
            split[name] = split.get(name, 0.0) + e.device_time_total / 1e3
    return list(split.items())


def _wkv6_inputs(torch, gen, dev, B, T, kind):
    """r, k, v ~ N(0, 1) bfloat16, u ~ N(0, 0.25) and w float32: ``model``
    w = exp(-exp(U(-6, -1))) (log w from -0.0025 to -0.37, the spread a
    trained decay LoRA gives around w0), ``brutal`` 1e-4, ``long``
    exp(-exp(-8)) = 0.99966, ``clamp`` model decays with every third
    token's even channels at 1 - 1e-8 (1.0 in float32) and the next
    token's every fourth at 0.9999999, where the log clamp holds."""
    BH, N = B * RWKV_H, RWKV_N

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k, v = (rn(BH, T, N).bfloat16() for _ in range(3))
    if kind == "brutal":
        w = torch.full((BH, T, N), 1e-4, device=dev)
    elif kind == "long":
        w = torch.full((BH, T, N), math.exp(-math.exp(-8.0)), device=dev)
    else:
        w = torch.exp(-torch.exp(-6 + 5 * torch.rand((BH, T, N), generator=gen,
                                                      device=dev)))
        if kind == "clamp":
            w[:, ::3, ::2] = 1 - 1e-8
            w[:, 1::3, 1::4] = 0.9999999
    return r, k, v, w, 0.5 * rn(RWKV_H, N), rn(BH, T, N)


def _to_model(t, B: int):
    """``[B*H, T, N]`` rows as the model's ``[B, T, H, N]`` (a strided view)."""
    return t.view(B, RWKV_H, t.shape[1], -1).permute(0, 2, 1, 3)


def _to_rows(t):
    """The model's ``[B, T, H, N]`` as contiguous ``[B*H, T, N]`` rows."""
    return t.permute(0, 2, 1, 3).reshape(-1, t.shape[1], t.shape[3])


def check_wkv6_kernels(torch, dev) -> dict:
    """K5 forward and backward against the plain version in float64.
    ``layout`` "model" calls the kernels as ``wkv6()`` does on the main
    path: r, k, v, w in the model's contiguous ``[B, T, H, N]`` and dy in
    the same layout (autograd hands it so); "model, dy strided" passes dy
    as a permuted view of rows, a layout of its own; "rows" is ``[B*H, T,
    N]``.  The plain version takes the same values as rows."""
    from repro_torch.kernels.wkv6 import (
        wkv6_bwd_kernel, wkv6_bwd_plain, wkv6_fwd_kernel, wkv6_plain)

    gen = torch.Generator(device=dev).manual_seed(4)
    # (max |error|, largest row error of the float32 outputs, of the
    # bfloat16 outputs)
    worst = {"wkv6_fwd": (0.0, 0.0, 0.0), "wkv6_bwd": (0.0, 0.0, 0.0)}

    def case(B, T, kind, what, layout="rows"):
        r, k, v, w, u, dy = _wkv6_inputs(torch, gen, dev, B, T, kind)
        ins, dy_in = (r, k, v, w), dy
        if layout != "rows":
            ins = [_to_model(t, B).contiguous() for t in ins]
            dy_in = _to_model(dy, B)
            if layout == "model":
                dy_in = dy_in.contiguous()
        y, st = wkv6_fwd_kernel(*ins, u)
        grads = wkv6_bwd_kernel(*ins, u, dy_in)
        torch.cuda.synchronize()
        if layout != "rows":
            del ins, dy_in
            y, st = _to_rows(y), st.view(-1, RWKV_N, RWKV_N)
            grads = [_to_rows(g) for g in grads[:4]] + [grads[4]]
        f64 = [t.double() for t in (r, k, v, w, u, dy)]
        ry, rs = wkv6_plain(*f64[:5])
        refs = wkv6_bwd_plain(*f64)
        e = {"y": _row_err(y, ry), "state": _row_err(st, rs)}
        e.update({n: _row_err(g, rg) for n, g, rg
                  in zip(("dr", "dk", "dv", "dw", "du"), grads, refs)})
        a_f = max(_err(y, ry), _err(st, rs))
        a_b = max(_err(g, rg) for g, rg in zip(grads, refs))
        del ry, rs, refs, f64
        torch.cuda.empty_cache()
        lim = {n: WKV_BF16_ROW_RTOL if n in ("dr", "dk", "dv") else WKV_F32_ROW_RTOL
               for n in e}
        ok = all(e[n] <= lim[n] for n in e)
        log(f"[kernels] wkv6          {what:50s} "
            + " ".join(f"{n}_row_err={x:.3e}" for n, x in e.items())
            + f" tol={WKV_F32_ROW_RTOL:.0e}/{WKV_BF16_ROW_RTOL:.2e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"wkv6 disagrees with its plain version: {what}")
        worst["wkv6_fwd"] = tuple(map(max, worst["wkv6_fwd"],
                                      (a_f, max(e["y"], e["state"]), 0.0)))
        worst["wkv6_bwd"] = tuple(map(max, worst["wkv6_bwd"], (
            a_b, max(e["dw"], e["du"]), max(e["dr"], e["dk"], e["dv"]))))

    B, T = RWKV_TRAIN["global_batch"], RWKV_TRAIN["seq_len"]
    case(B, T, "model", f"[B, T, H, N] B={B} T={T} H=40 N=64 (main shape)", "model")
    case(B, 100, "model", "rows B=4 T=100 H=40 ragged")
    case(1, 512, "brutal", "rows B=1 T=512 brutal decay w=1e-4")
    case(1, T, "long", f"rows B=1 T={T} long memory w=0.99966")
    case(1, 100, "clamp", "rows B=1 T=100 w >= 1-1e-7 in places (clamped)")
    case(2, 129, "model", "[B, T, H, N], dy strided, B=2 T=129 (2 x 64 + 1)",
         "model, dy strided")
    return worst


def time_wkv6_kernels(torch, dev, worst: dict) -> dict:
    """K5: kernel and plain times at the training path's shape, bounds, and
    each call split into its kernels under ``torch.profiler``.  The kernels
    are timed in the main path's layout (the model's ``[B, T, H, N]``, dy
    too), with their time on ``[B*H, T, N]`` rows logged beside."""
    from repro_torch.kernels.wkv6 import (
        wkv6_bwd_kernel, wkv6_bwd_plain, wkv6_fwd_kernel, wkv6_plain)

    gen = torch.Generator(device=dev).manual_seed(5)
    B, T = RWKV_TRAIN["global_batch"], RWKV_TRAIN["seq_len"]
    r, k, v, w, u, dy = _wkv6_inputs(torch, gen, dev, B, T, "model")
    rm, km, vm, wm, dym = (_to_model(t, B).contiguous() for t in (r, k, v, w, dy))
    BH, N = B * RWKV_H, RWKV_N
    elems = BH * T * N
    # forward: r, k, v bf16 and w float32 in; y float32 and the state out.
    # backward: r, k, v bf16, w and dy float32 in; dr, dk, dv bf16, dw
    # float32 and du out (24 bytes a token and channel).  Operations: the
    # chunk form's tensor-core products (chunk 64, sub-chunk 16; each counted
    # once, not per bf16 part) a token and head, forward the chunk's state
    # contribution, the state product and the sub-chunk state updates (6 N^2)
    # and A v (32 N), backward U, W, the sub-chunk states, dy S^T, v G^T,
    # (k e^sfx) G and the G updates (14 N^2), M and A^T dy (64 N), at the
    # bf16 tensor-core rate; the pair scores on CUDA cores are not counted.
    # PR 13-16's bounds counted the sequential recurrence's N^2 FMAs on
    # float32 CUDA cores (4 N^2 forward, 12 N^2 backward): logged beside.
    fwd_bytes = 3 * 2 * elems + 4 * elems + 4 * elems + 4 * BH * N * N + 4 * RWKV_H * N
    bwd_bytes = 3 * 2 * elems + 2 * 4 * elems + 4 * RWKV_H * N + 3 * 2 * elems \
        + 4 * elems + 4 * RWKV_H * N
    rows = {
        "wkv6_fwd": (lambda: wkv6_fwd_kernel(rm, km, vm, wm, u),
                     lambda: wkv6_fwd_kernel(r, k, v, w, u),
                     lambda: wkv6_plain(r, k, v, w, u),
                     bound((6 * N * N + 32 * N) * BH * T, fwd_bytes),
                     bound(4 * N * N * BH * T, fwd_bytes, F32_FLOPS_PER_S)),
        "wkv6_bwd": (lambda: wkv6_bwd_kernel(rm, km, vm, wm, u, dym),
                     lambda: wkv6_bwd_kernel(r, k, v, w, u, dy),
                     lambda: wkv6_bwd_plain(r, k, v, w, u, dy),
                     bound((14 * N * N + 64 * N) * BH * T, bwd_bytes),
                     bound(12 * N * N * BH * T, bwd_bytes, F32_FLOPS_PER_S)),
    }
    out = {}
    for name, (kern, kern_rows, plain, (b_ms, b_by), (old_ms, old_by)) in rows.items():
        out[name] = dict(ms=cuda_ms(kern, 10), plain_ms=cuda_ms(plain, 3, warmup=1),
                         library_ms=None, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=worst[name][0], max_row_err=worst[name][1],
                         tolerance=WKV_F32_ROW_RTOL)
        if name == "wkv6_bwd":  # dr, dk, dv are bfloat16
            out[name].update(max_row_err_bf16=worst[name][2],
                             tolerance_bf16=WKV_BF16_ROW_RTOL)
        t = out[name]
        log(f"[timing] {name:13s} its kernels (torch.profiler, one call): "
            + ", ".join(f"{kn} {ms:.4f} ms" for kn, ms in _kernel_split(torch, kern)))
        log(f"[timing] {name:13s} B={B} T={T} H=40 N=64: kernel_ms={t['ms']:.4f} "
            f"([B, T, H, N]; on [B*H, T, N] rows {cuda_ms(kern_rows, 10):.4f}) "
            f"plain_ms={t['plain_ms']:.4f} library_ms=none (no PyTorch call "
            f"computes WKV-6) bound_ms={b_ms:.6f} ({b_by}; the sequential form's "
            f"float32 CUDA-core bound {old_ms:.6f}, {old_by})")
    return out


def _rglru_inputs(torch, gen, dev, B, T, W, kind):
    """a, b float32 ``[B, T, W]`` as Griffin makes them (``model``: log a =
    -8 softplus(lam) r, lam ~ U(-1, 1), r = sigmoid(N(0, 1)); b = sqrt(1 -
    a^2) x), under ``brutal`` decay (log a ~ U(-12, 0)) or with ``long``
    memory (log a ~ U(-1e-2, -1e-4), where the carries dominate); dy ~ N(0,
    1)."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    if kind == "brutal":
        log_a = -12 * torch.rand((B, T, W), generator=gen, device=dev)
    elif kind == "long":
        log_a = -(1e-4 + (1e-2 - 1e-4) * torch.rand((B, T, W), generator=gen,
                                                     device=dev))
    else:
        lam = 2 * torch.rand((W,), generator=gen, device=dev) - 1
        log_a = -8 * torch.logaddexp(lam, torch.zeros_like(lam)) * torch.sigmoid(
            rn(B, T, W))
    b = torch.sqrt(-torch.expm1(2 * log_a)) * rn(B, T, W)
    return torch.exp(log_a), b, rn(B, T, W)


def check_rglru_kernels(torch, dev) -> dict:
    """K6 forward and backward against the plain version in float64."""
    from repro_torch.kernels.rglru import (
        rglru_bwd_kernel, rglru_bwd_plain, rglru_fwd_kernel, rglru_plain)

    gen = torch.Generator(device=dev).manual_seed(6)
    worst = {"rglru_fwd": (0.0, 0.0), "rglru_bwd": (0.0, 0.0)}

    def case(B, T, W, kind, with_dh, what, twice=False):
        a, b, dy = _rglru_inputs(torch, gen, dev, B, T, W, kind)
        dh = torch.randn((B, W), generator=gen, device=dev) if with_dh else None
        y, h_last = rglru_fwd_kernel(a, b)
        da, db = rglru_bwd_kernel(a, y, dy, dh)
        torch.cuda.synchronize()
        if twice:  # a fixed order and no atomics: the same bits again
            again = (*rglru_fwd_kernel(a, b), *rglru_bwd_kernel(a, y, dy, dh))
            same = [torch.equal(x, x2) for x, x2 in zip((y, h_last, da, db), again)]
            log(f"[kernels] rglru         {what:50s} second run bit-identical "
                f"(y, h_last, da, db): {same}")
            if not all(same):
                raise AssertionError(f"rglru differs on a second run: {what}")
        a64 = a.double()
        ry, rh = rglru_plain(a64, b.double())
        rda, rdb = rglru_bwd_plain(a64, ry, dy.double(),
                                   None if dh is None else dh.double())
        e = {"y": _row_err(y, ry), "h_last": _row_err(h_last, rh),
             "da": _row_err(da, rda), "db": _row_err(db, rdb)}
        a_f = max(_err(y, ry), _err(h_last, rh))
        a_b = max(_err(da, rda), _err(db, rdb))
        del a64, ry, rh, rda, rdb
        ok = max(e.values()) <= RGLRU_ROW_RTOL
        log(f"[kernels] rglru         {what:50s} "
            + " ".join(f"{n}_row_err={x:.3e}" for n, x in e.items())
            + f" tol={RGLRU_ROW_RTOL:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"rglru disagrees with its plain version: {what}")
        worst["rglru_fwd"] = tuple(map(max, worst["rglru_fwd"],
                                       (a_f, max(e["y"], e["h_last"]))))
        worst["rglru_bwd"] = tuple(map(max, worst["rglru_bwd"],
                                       (a_b, max(e["da"], e["db"]))))

    B, T, W = GRIFFIN_TRAIN["global_batch"], GRIFFIN_TRAIN["seq_len"], GRIFFIN_W
    case(B, T, W, "model", False, f"[{B}, {T}, {W}] Griffin decays (main shape)",
         twice=True)
    case(1, 1000, 1000, "model", True, "[1, 1000, 1000] ragged T and W, dh_last")
    case(1, 512, W, "brutal", True, f"[1, 512, {W}] brutal decay log a in [-12, 0]")
    # the windows: T = 15 x 64 + 43 ends part way through a window's sixth
    # piece, W = 130 a block's lanes part way (and a row stride no multiple
    # of 16 bytes); 2 blocks for 132 SMs; carries that dominate
    case(2, 1003, 130, "model", True, "[2, 1003, 130] T mid-window, W = 130, dh_last",
         twice=True)
    case(1, T, 64, "model", True, f"[1, {T}, 64] a grid of 2 blocks, dh_last")
    case(1, 2048, W, "long", True, f"[1, 2048, {W}] long memory log a in [-1e-2, -1e-4]")
    return worst


def time_rglru_kernels(torch, dev, worst: dict) -> dict:
    """K6: kernel and plain times at the Griffin training shape, and bounds.
    The kernels are timed through CUDA graphs (a call of ~0.1 ms is near
    what the host takes to issue one), with their host-paced times beside."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru import (
        rglru_bwd_kernel, rglru_bwd_plain, rglru_fwd_kernel, rglru_plain)

    gen = torch.Generator(device=dev).manual_seed(7)
    B, T, W = GRIFFIN_TRAIN["global_batch"], GRIFFIN_TRAIN["seq_len"], GRIFFIN_W
    a, b, dy = _rglru_inputs(torch, gen, dev, B, T, W, "model")
    y, _ = rglru_fwd_kernel(a, b)
    n = B * T * W
    # forward: a, b in, y out (float32) and the last state; one FMA an
    # element.  backward: a, y, dy in, da, db out; three flops an element
    nbytes = {"rglru_fwd": 3 * 4 * n + 4 * B * W, "rglru_bwd": 5 * 4 * n}
    rows = {
        "rglru_fwd": (lambda: rglru_fwd_kernel(a, b), lambda: rglru_plain(a, b),
                      bound(2 * n, nbytes["rglru_fwd"], F32_FLOPS_PER_S)),
        "rglru_bwd": (lambda: rglru_bwd_kernel(a, y, dy),
                      lambda: rglru_bwd_plain(a, y, dy),
                      bound(3 * n, nbytes["rglru_bwd"], F32_FLOPS_PER_S)),
    }
    out = {}
    for name, (kern, plain, (b_ms, b_by)) in rows.items():
        out[name] = dict(ms=cuda_ms(kern, 50, graph=True),
                         plain_ms=cuda_ms(plain, 2, warmup=1),
                         library_ms=None, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=worst[name][0], max_row_err=worst[name][1],
                         tolerance=RGLRU_ROW_RTOL)
        t = out[name]
        regs = [ln for ln in _build.ptxas_report(name) if "registers" in ln]
        log(f"[timing] {name:13s} [{B}, {T}, {W}] float32: kernel_ms={t['ms']:.4f} "
            f"(CUDA graph; host-paced {cuda_ms(kern, 20):.4f}) "
            f"{nbytes[name] / t['ms'] / 1e9:.3f} TB/s, {b_ms / t['ms']:.3f} of the "
            f"bound; plain_ms={t['plain_ms']:.4f} library_ms=none (no PyTorch call "
            f"computes the recurrence exactly) bound_ms={b_ms:.6f} ({b_by}, "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); ptxas: {'; '.join(regs)}")
    return out


def _window_pairs(S: int, window: int) -> int:
    """Query-key pairs one head sees under the causal window."""
    return sum(min(i + 1, window) for i in range(S))


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
    # warm-up: MegaServe.precompile() runs every bucket's step once (K1's
    # Triton specialisations, the kernels' first launches, cuBLAS, the
    # allocator) and leaves the pool, the scheduler and the launch counts
    # as they were; then time the workload afresh
    reset_launches()
    rmsnorm.reset_launches()
    rep = srv.precompile()
    log(f"[serve] precompile: {_precompiled(rep)}")
    if any({**launches, **rmsnorm.launches}.values()) or not rep["total"]:
        raise AssertionError(f"[serve] precompile left launch counts "
                             f"{ {**launches, **rmsnorm.launches} } or warmed nothing")
    srv.reset()
    torch.cuda.reset_peak_memory_stats()

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


PRECOMPILE_ARGV = ["serve", "--arch", "qwen2-0.5b", "--continuous", "--requests", "2",
                   "--max-new", "12", "--modules", "none"]
PRECOMPILE_PATHS = ("decode", "prefill", "chunk", "verify")


def _precompiled(rep: dict) -> str:
    """A precompile report's per-path counts and ms, and its total."""
    return ", ".join(f"{p} {rep[p]['count']} in {rep[p]['ms']:.1f} ms"
                     for p in PRECOMPILE_PATHS) + f"; total {rep['total']}"


def _cache_files(root: Path) -> dict:
    """Every file under ``root`` (Triton's cache included): path -> (size,
    mtime)."""
    return {str(f.relative_to(root)): (f.stat().st_size, f.stat().st_mtime_ns)
            for f in root.rglob("*") if f.is_file()}


def precompile_phase(smi: str, tag: str = "precompile") -> None:
    """Two fresh ``python -m repro_torch serve --arch qwen2-0.5b
    --continuous`` processes at full width, 2 requests of up to 12 tokens,
    through one ``--compile-cache`` directory (emptied first): each
    precompiles its buckets before the first request.  The cold one builds
    the libraries its buckets launch into the cache (K3's and K4's: a miss
    and a put each, beside a record a bucket) and K1's Triton binaries
    under it; the warm one hits every entry the cold one put, misses none
    and writes no file there (so ran no nvcc and no Triton compile).  Both
    report per-path ``{count, ms}`` and stream the same tokens."""
    import shutil

    root = RUNTIME_DIR / "compile_cache"
    shutil.rmtree(root, ignore_errors=True)
    argv = [sys.executable, "-m", "repro_torch", *PRECOMPILE_ARGV, "--compile-cache",
            str(root)]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    log(f"[{tag}] python -m repro_torch {' '.join(argv[3:])}, twice")
    out = {}
    for run in ("cold", "warm"):
        before = _cache_files(root) if root.exists() else {}
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"{tag} {run}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        lines = proc.stdout.splitlines()
        rep = next(json.loads(ln) for ln in lines if ln.startswith("{") and "precompile" in ln)
        rep = rep["precompile"]
        streams = [ln.strip() for ln in lines if ln.strip().startswith("req ")]
        files = _cache_files(root)
        new = sorted(set(files) - set(before))
        changed = sorted(k for k in before if files.get(k) != before[k])
        out[run] = dict(rep=rep, streams=streams, new=new, changed=changed)
        log(f"[{tag}] {run}: process {wall:.1f} s; precompile {_precompiled(rep)}; "
            f"cache {rep['cache']}; new files {len(new)} "
            f"(libraries {[f for f in new if f.endswith('.so')]}, Triton "
            f"{sum(f.startswith('triton') or '/triton/' in f for f in new)}), changed "
            f"{len(changed)}; streams {streams} ({smi})")
    cold, warm = out["cold"], out["warm"]
    libs = [f for f in cold["new"] if f.endswith(".so")]
    if (not libs or cold["rep"]["cache"]["hits"] or not cold["rep"]["total"]
            or cold["rep"]["cache"]["puts"] != cold["rep"]["cache"]["misses"]):
        raise AssertionError(f"{tag}: the cold process built no library into the cache "
                             f"or hit an entry: {cold['rep']}")
    if (warm["rep"]["cache"] != {"hits": cold["rep"]["cache"]["puts"], "misses": 0,
                                 "puts": 0, "errors": 0}
            or warm["new"] or warm["changed"]):
        raise AssertionError(f"{tag}: the warm process built again: {warm['rep']}, new "
                             f"{warm['new']}, changed {warm['changed']}")
    counts = [[r["rep"][p]["count"] for p in PRECOMPILE_PATHS] for r in (cold, warm)]
    if warm["streams"] != cold["streams"] or len(cold["streams"]) != 2 or \
            counts[0] != counts[1]:
        raise AssertionError(f"{tag}: cold and warm differ: {cold['streams']} / "
                             f"{warm['streams']}")


def serve_session(torch, cfg, specs, streams_off: dict, ticks_off: list,
                  smi: str, tag: str = "serve-session") -> dict:
    """The serve phase's workload again, through ``Session`` as ``python -m
    repro_torch serve --continuous`` runs it, with ``--modules
    scan,metrics`` and a chrome trace, then in turns with ``scan`` (four
    runs each), then ``none``: the streams of all must be
    token-identical to the direct run's (no plugins, its own tracer, which
    times its ticks: ``streams_off``, ``ticks_off``), every decode tick and
    prompt of the first must launch the paged kernels once a layer and K1
    once a norm, and its registry's TTFT histogram must count every request
    once.  Logs each run's median decode tick beside the direct run's, and
    each side's ticks pooled.  Returns the first run's launch counts."""
    from repro_torch.kernels import rmsnorm
    from repro_torch.kernels.paged_attention import launches, reset_launches

    out_dir = RUNTIME_DIR / "trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    base = ["serve", "--arch", cfg.name, "--continuous",
            "--requests", str(SERVE["n"]), "--rate", str(SERVE["rate"]),
            "--prompt-lens", ",".join(map(str, SERVE["prompt_lens"])),
            "--max-new", str(SERVE["max_new_range"][1]),
            "--slots", str(SERVE["num_slots"]), "--block-size", str(SERVE["block_size"]),
            "--seed", str(SERVE["seed"])]
    argv = [*base, "--modules", "scan,metrics", "--trace-out", str(out_dir / "serve.json")]
    if SERVE["max_new_range"][0] != max(1, SERVE["max_new_range"][1] // 4):
        raise AssertionError("the CLI derives max_new's lower end as max_new // 4")
    log(f"[{tag}] python -m repro_torch {' '.join(argv)}")
    reset_launches()
    rmsnorm.reset_launches()
    with _GcPauses() as pauses:
        session, (streams, met) = _session(argv)
    torch.cuda.synchronize()
    counts = {**launches, **rmsnorm.launches}
    events = session.tracer.events
    ticks = [e.dur for e in events if e.name == "decode"]
    n_prefill = sum(e.name == "prefill" for e in events)
    L = cfg.num_layers
    snap = session.metrics_registry.snapshot()
    log(f"[{tag}] finished={met['finished']}/{len(specs)} "
        f"tokens_per_s={met['tokens_per_s']:.2f} ttft_p50_s={met['ttft_p50_s']:.4f} "
        f"ttft_p99_s={met['ttft_p99_s']:.4f} ticks={len(ticks)} prefills={n_prefill}; "
        f"registry ttft_s count {snap['serve.ttft_s']['count']}, tokens "
        f"{snap['serve.tokens']:.0f}; launches {counts}")
    log(f"[{tag}] decode tick median with --modules scan,metrics "
        f"{1e3 * statistics.median(ticks):.3f} ms over {len(ticks)} ticks; direct "
        f"run, no plugins: {1e3 * statistics.median(ticks_off):.3f} ms over "
        f"{len(ticks_off)} ticks ({smi}); Python during the run: {pauses}")
    if streams != streams_off:
        bad = [rid for rid in streams_off if streams.get(rid) != streams_off[rid]]
        raise AssertionError(f"{tag}: streams differ from the direct run's: rids {bad}")
    if counts["paged_decode"] != len(ticks) * L or counts["paged_prefill"] != n_prefill * L:
        raise AssertionError(f"{tag}: paged launches {counts} != ticks/prompts x layers")
    if (counts["rmsnorm_fwd"] != (2 * L + 1) * (len(ticks) + n_prefill)
            or counts["rmsnorm_bwd"] != 0):
        raise AssertionError(f"{tag}: rmsnorm launches != (2 x layers + 1) x forwards")
    if snap["serve.ttft_s"]["count"] != len(specs) or met["finished"] != len(specs):
        raise AssertionError(f"{tag}: TTFT histogram counts "
                             f"{snap['serve.ttft_s']['count']} of {len(specs)} requests")
    # --modules scan (the tracer alone: no registry, no trace file, so no
    # writer thread) still times its ticks; --modules none does not.  In
    # turns with the first run, four of each (on, scan, scan, on, on, scan,
    # scan, on), so neither side holds one place in the order, as a run's
    # median moves by several ms from run to run; then none
    pooled = {"scan,metrics": list(ticks), "scan": []}
    medians = {"scan,metrics": [statistics.median(ticks)], "scan": []}
    for modules in ("scan", "scan", "scan,metrics", "scan,metrics", "scan", "scan",
                    "scan,metrics", "none"):
        extra = (["--trace-out", str(out_dir / "serve.json")]
                 if modules == "scan,metrics" else [])
        sess, (streams_m, met_m) = _session([*base, "--modules", modules, *extra])
        ticks_m = [e.dur for e in sess.tracer.events if e.name == "decode"]
        if modules in pooled:
            pooled[modules].extend(ticks_m)
            medians[modules].append(statistics.median(ticks_m))
        median = f"{1e3 * statistics.median(ticks_m):.3f} ms" if ticks_m else "not measured"
        log(f"[{tag}] --modules {modules}: decode tick median {median}, "
            f"tokens_per_s={met_m['tokens_per_s']:.2f} "
            f"ttft_p50_s={met_m['ttft_p50_s']:.4f} ttft_p99_s={met_m['ttft_p99_s']:.4f} "
            f"wall_s={met_m['wall_s']:.3f}; streams "
            f"{'equal' if streams_m == streams_off else 'DIFFER'}")
        if streams_m != streams_off:
            raise AssertionError(f"{tag}: --modules {modules} streams differ from the "
                                 "direct run's")
    for modules, ticks_m in pooled.items():
        m = medians[modules]
        log(f"[{tag}] decode ticks of the {len(m)} --modules {modules} runs pooled: "
            f"median {1e3 * statistics.median(ticks_m):.3f} ms; run medians "
            f"{1e3 * min(m):.3f}-{1e3 * max(m):.3f} ms ({smi})")
    return counts


# ------------------------------------------------------- serve_paths


class _ReplayDrafter:
    """A test-only drafter: for the request whose prompt starts the history,
    the continuation a reference run emitted, while the history follows
    that run's stream; nothing once it has left it."""

    def __init__(self, refs: dict[tuple, list[int]]):
        self.refs = refs
        self.lens = sorted({len(p) for p in refs})

    def propose(self, history: list[int], k: int) -> list[int]:
        for n in self.lens:
            stream = self.refs.get(tuple(history[:n]))
            if stream is not None:
                gen = history[n:]
                if gen != stream[:len(gen)]:
                    return []
                return stream[len(gen):len(gen) + k]
        return []


def _paths_server(torch, cfg, scfg, **kw):
    from repro_torch.models import lm
    from repro_torch.serve.server import MegaServe

    return MegaServe(cfg, lm.init(cfg, seed=0, device="cuda"), scfg, device="cuda", **kw)


def _free(torch) -> None:
    gc.collect()  # a server holds itself in a reference cycle
    torch.cuda.empty_cache()


def _counted(torch, fn):
    """``fn()``'s result and the paged kernels' and K1's launches in it."""
    from repro_torch.kernels import rmsnorm
    from repro_torch.kernels.paged_attention import launches, reset_launches

    reset_launches()
    rmsnorm.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {**launches, **rmsnorm.launches}


def _expect_launches(tag: str, cfg, counts: dict, events, *, static_steps: int = 0,
                     phase: str = "serve-paths") -> dict:
    """Each forward launches K1 once a norm (2L + 1, no qk_norm in qwen2);
    K4 once a layer for every flash prefill, chunk and verify step; K3 once
    a layer for every paged decode tick; the gathered path's decode and the
    dense prefill (its prefill events when ``gathered``) run no paged
    kernel, one B=1 forward per active slot.  Fails unless ``counts``
    equal what the events say."""
    L = cfg.num_layers
    n = {k: 0 for k in ("prefill", "prefill_chunk", "decode", "verify")}
    slot_forwards = 0
    for e in events:
        if e.name in n:
            n[e.name] += 1
            if e.name == "decode":
                slot_forwards += e.args.get("active", 0)
    gathered = tag.endswith("gathered")
    if static_steps:
        want = {"paged_prefill": 0, "paged_decode": 0,
                "rmsnorm_fwd": (2 * L + 1) * static_steps}
    elif gathered:
        want = {"paged_prefill": 0, "paged_decode": 0,
                "rmsnorm_fwd": (2 * L + 1) * (n["prefill"] + slot_forwards)}
    else:
        want = {"paged_prefill": L * (n["prefill"] + n["prefill_chunk"] + n["verify"]),
                "paged_decode": L * n["decode"],
                "rmsnorm_fwd": (2 * L + 1) * sum(n.values())}
    want["rmsnorm_bwd"] = 0
    got = {k: counts[k] for k in want}
    log(f"[{phase}] {tag}: events {n}; launches {got}, expected {want}")
    if got != want:
        raise AssertionError(f"{phase} {tag}: launches {got} != {want}")
    return n


def _paths_metrics(tag: str, met: dict, events) -> None:
    def med(name):
        d = [e.dur for e in events if e.name == name]
        return f"{1e3 * statistics.median(d):.3f} ms x{len(d)}" if d else "none"

    spec = ""
    if "spec_proposed" in met:
        ver = [e for e in events if e.name == "verify"]
        emitted = sum(e.args["tokens"] for e in ver)
        spec = (f" spec_proposed={met['spec_proposed']} spec_accepted="
                f"{met['spec_accepted']} accept_rate={met['spec_accept_rate']:.3f}"
                f" tokens_per_verify_step={emitted / max(len(ver), 1):.3f}"
                f" tokens_per_slot_verify="
                f"{emitted / max(sum(e.args['active'] for e in ver), 1):.3f}")
    log(f"[serve-paths] {tag}: finished={met['finished']} tokens={met['generated_tokens']} "
        f"tokens_per_s={met['tokens_per_s']:.2f} ttft_p50_s={met['ttft_p50_s']:.4f} "
        f"ttft_p99_s={met['ttft_p99_s']:.4f} wall_s={met['wall_s']:.3f} "
        f"steps={met['steps']}; decode tick {med('decode')}, chunk {med('prefill_chunk')}, "
        f"verify {med('verify')}, prefill {med('prefill')}{spec}")


def _check_streams(tag: str, cfg, specs, streams: dict) -> None:
    for s in specs:
        toks = streams[s.rid]
        if len(toks) != s.max_new or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"serve-paths {tag}: request {s.rid}: bad stream "
                                 f"{toks[:8]}...")


def _replay_chunked(torch, cfg, params, prompt, forced, *, plain, max_blocks):
    """Teacher-forced logits of ``forced`` after ``prompt`` through the
    chunked prefill path: the prompt in ``CHUNK``-token chunks at block
    starts (table widths bucketed as MegaServe buckets them), then paged
    decode, one token at a time, in a pool of its own."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import make_chunk_prefill_step, make_paged_decode_step
    from repro_torch.serve.paged_cache import blocks_for, pow2_bucket

    dev = torch.device("cuda")
    step = make_chunk_prefill_step(cfg, block_size=BS, plain=plain)
    decode = make_paged_decode_step(cfg, block_size=BS, plain=plain)
    pool = lm.init_pool(cfg, max_blocks + 1, BS, dev)
    table = torch.arange(1, max_blocks + 1, dtype=torch.int32, device=dev)[None]
    P = len(prompt)
    for w in range(0, P, CHUNK):
        chunk = prompt[w:w + CHUNK]
        n_last = (P - 1 - w) if w + CHUNK >= P else len(chunk) - 1
        width = min(pow2_bucket(blocks_for(w + CHUNK, BS)), max_blocks)
        logits, _ = step(params, pool, table[:, :width].contiguous(),
                         torch.tensor([chunk + [0] * (CHUNK - len(chunk))], device=dev),
                         torch.tensor([w], dtype=torch.int32, device=dev), n_last)
    out = [logits]
    for i, tok in enumerate(forced[:-1]):
        pos = P + i
        hb = min(pow2_bucket(blocks_for(pos + 1, BS)), max_blocks)
        out.append(decode(params, pool, table[:, :hb].contiguous(),
                          torch.tensor([tok], device=dev),
                          torch.tensor([pos], dtype=torch.int32, device=dev))[0][0])
    return torch.stack(out).float()


def _replay_verify(torch, cfg, params, prompt, forced, *, plain, max_blocks):
    """Teacher-forced logits of ``forced`` after ``prompt`` through the
    speculative path: the flash prefill of the padded prompt, then verify
    steps of Q = SPEC_K + 1 rows (the last committed token and the next
    SPEC_K tokens of ``forced`` as the draft, all accepted; the last step's
    missing rows padded), in a pool of its own."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import make_flash_prefill_step, make_spec_verify_step
    from repro_torch.serve.paged_cache import blocks_for, pow2_bucket

    dev = torch.device("cuda")
    prefill = make_flash_prefill_step(cfg, block_size=BS, plain=plain)
    verify = make_spec_verify_step(cfg, block_size=BS, plain=plain)
    pool = lm.init_pool(cfg, max_blocks + 1, BS, dev)
    table = torch.arange(1, max_blocks + 1, dtype=torch.int32, device=dev)[None]
    P = len(prompt)
    n_blk = min(pow2_bucket(blocks_for(P, BS)), max_blocks)
    toks = torch.tensor([prompt + [0] * (n_blk * BS - P)], device=dev)
    rows = [prefill(params, pool, table[:, :n_blk].contiguous(), toks, P)[0]]
    j, pos = 0, P
    while j < len(forced) - 1:
        d = forced[j + 1:j + 1 + SPEC_K]
        hb = min(pow2_bucket(blocks_for(pos + 1 + len(d), BS)), max_blocks)
        logits, _ = verify(params, pool, table[:, :hb].contiguous(),
                           torch.tensor([[forced[j]] + d + [0] * (SPEC_K - len(d))],
                                        device=dev),
                           torch.tensor([pos], dtype=torch.int32, device=dev))
        rows.extend(logits[0, :len(d) + 1])
        j += len(d) + 1
        pos += len(d) + 1
    return torch.stack(rows[:len(forced)]).float()


def _teacher_forced_paths(torch, cfg, params, specs, prompts, streams, replay_fn,
                          tag: str, max_blocks: int) -> None:
    """Every stream replayed teacher-forced through ``replay_fn``'s path,
    the kernels against the plain versions: logits within ``LOGIT_TOL``,
    each served token within it of the plain path's largest logit."""
    V = cfg.vocab_size
    worst = 0.0
    for s in specs:
        forced, prompt = streams[s.rid], prompts[s.rid]
        lk = replay_fn(torch, cfg, params, prompt, forced, plain=False,
                       max_blocks=max_blocks)
        lp = replay_fn(torch, cfg, params, prompt, forced, plain=True,
                       max_blocks=max_blocks)
        err = (lk[:, :V] - lp[:, :V]).abs().max().item()
        idx = torch.tensor(forced, device=lp.device)[:, None]
        gap = (lp[:, :V].max(-1).values - lp.gather(1, idx)[:, 0]).max().item()
        agree = (lk[:, :V].argmax(-1) == lp[:, :V].argmax(-1)).float().mean().item()
        ok = err <= LOGIT_TOL and gap <= LOGIT_TOL and bool(torch.isfinite(lk).all())
        worst = max(worst, err)
        log(f"[serve-paths] {tag} rid={s.rid} prompt={len(prompt)} steps={len(forced)} "
            f"max_logit_err={err:.4f} max_gap_to_plain_max={gap:.4f} "
            f"argmax_agree={agree:.3f} tol={LOGIT_TOL} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"serve-paths {tag}: teacher-forced check failed "
                                 f"for rid {s.rid}")
    log(f"[serve-paths] {tag}: {len(specs)} streams, worst max_logit_err {worst:.4f}")


def serve_paths(torch, smi: str, tag: str = "serve-paths") -> dict:
    """MegaServe's single-engine paths on full-width, full-depth qwen2-0.5b
    (seed-0 weights, bf16, 8 slots of block 16, the serve phase's pool of
    blocks) on :data:`PATHS`' 8 Poisson requests: the paged flash path as
    the base; chunked prefill; speculation with the n-gram drafter and with
    a drafter replaying that run's own streams; the MegaScope probe on the
    gathered path (2 requests); static serving.  Each through MegaServe (or
    ``StaticRunner``) and once through ``Session``.  Gates: every request
    finishes with a valid stream; K4, K3 and K1 launch exactly as the
    prefills, chunks, verify steps and ticks say; the chunked and the
    speculative streams replayed teacher-forced through their own paths,
    kernels against plain versions, within ``LOGIT_TOL``; the replaying
    drafter's drafts all accepted (a rejection passes only at a near-tie of
    its verify row, logged); a capture on every gathered-path token; the
    Session's chunked streams equal the direct run's; static serving's
    outputs equal ``StaticRunner``'s.  Returns the verify and chunk K4
    launch counts of the direct runs."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.core.scope import ProbeSpec, ScopeCollector
    from repro_torch.models import lm
    from repro_torch.serve.server import StaticRunner, make_poisson_workload

    cfg = get_config("qwen2-0.5b")
    L = cfg.num_layers
    pool_blocks = make_poisson_workload(cfg, **SERVE)[2].num_blocks
    specs, prompts, scfg = make_poisson_workload(cfg, **PATHS, num_blocks=pool_blocks)
    M = scfg.max_blocks_per_slot
    log(f"[{tag}] {cfg.name} {L} layers, {len(specs)} requests, prompts "
        f"{sorted({s.prompt_len for s in specs})}, max_new "
        f"{[s.max_new for s in specs]}; {scfg.num_slots} slots, {scfg.num_blocks} "
        f"blocks x {BS}, table width {M}; chunk {CHUNK}, spec_k {SPEC_K} ({smi})")

    def run(name, extra=None, *, subset=specs, arrivals=True, **kw):
        srv = _paths_server(torch, cfg, replace(scfg, **(extra or {})), **kw)

        def drain():
            for sp in subset:
                srv.submit(prompts[sp.rid], sp.max_new,
                           arrival=sp.arrival if arrivals else 0.0, rid=sp.rid)
            return srv.drain()

        streams, counts = _counted(torch, drain)
        met, events = srv.metrics(), list(srv.trace_events())
        if met["finished"] != len(subset):
            raise AssertionError(f"{tag} {name}: {met['finished']} of {len(subset)} "
                                 "requests finished")
        _check_streams(name, cfg, subset, streams)
        n = _expect_launches(name, cfg, counts, events)
        _paths_metrics(name, met, events)
        return srv, streams, n

    # warm-up (cuBLAS handles, the allocator) on the base path, then the base
    srv, _, _ = run("warm-up", subset=specs[:2])
    del srv
    srv, base, _ = run("base paged flash")
    params = srv.params
    del srv
    _free(torch)

    # (a) chunked prefill
    srv, chunked, n_chunk = run("chunked", dict(chunked_prefill=True))
    del srv
    same = sum(chunked[s.rid] == base[s.rid] for s in specs)
    log(f"[{tag}] chunked streams equal to the base path's: {same} of {len(specs)}")
    _teacher_forced_paths(torch, cfg, params, specs, prompts, chunked,
                          _replay_chunked, "chunked teacher-forced", M)
    _free(torch)

    # (b) speculation: the n-gram drafter, then a drafter replaying its streams
    srv, spec, n_ver = run("spec ngram", dict(spec_decode=True, spec_k=SPEC_K))
    del srv
    same = sum(spec[s.rid] == base[s.rid] for s in specs)
    log(f"[{tag}] speculative streams equal to the base path's: {same} of {len(specs)}")
    _teacher_forced_paths(torch, cfg, params, specs, prompts, spec,
                          _replay_verify, "spec teacher-forced", M)
    refs = {tuple(prompts[s.rid]): spec[s.rid] for s in specs}
    srv, replayed, _ = run("spec replay", dict(spec_decode=True, spec_k=SPEC_K),
                           drafter=_ReplayDrafter(refs))
    met = srv.metrics()
    del srv
    parted = [s for s in specs if replayed[s.rid] != spec[s.rid]]
    log(f"[{tag}] replaying drafter: proposed {met['spec_proposed']} accepted "
        f"{met['spec_accepted']}; streams parting from the replayed ones: "
        f"{[s.rid for s in parted]}")
    if met["spec_accepted"] != met["spec_proposed"] or parted:
        # a draft is rejected only where the verify row's argmax differs from
        # the replayed run's token: allowed at a near-tie of that row alone
        for s in parted or specs:
            lk = _replay_verify(torch, cfg, params, prompts[s.rid], spec[s.rid],
                                plain=False, max_blocks=M)[:, :cfg.vocab_size]
            i = next((i for i, (a, b) in enumerate(zip(replayed[s.rid], spec[s.rid]))
                      if a != b), None)
            if i is None:
                continue
            top2 = lk[i].topk(2).values
            near = (top2[0] - top2[1]).item()
            log(f"[{tag}] rid={s.rid} parts at token {i}: top-2 gap {near:.4f} "
                f"(tol {LOGIT_TOL})")
            if near > LOGIT_TOL:
                raise AssertionError(f"{tag}: a replayed draft was rejected away "
                                     f"from a near-tie (rid {s.rid}, token {i})")
    _free(torch)

    # (c) the MegaScope probe on the gathered path
    scope = ScopeCollector(probes=[ProbeSpec("final_hidden", "stats")])
    srv, _, _ = run("scope gathered", subset=specs[:SCOPE_REQUESTS], collector=scope)
    if srv.decode_path != "gathered":
        raise AssertionError(f"{tag}: a collector did not pick the gathered path")
    items = [it for s in specs[:SCOPE_REQUESTS] for it in srv.streams[s.rid]]
    _check_stream_captures(torch, tag, items)
    del srv
    _free(torch)

    # the same modes through the Session, as python -m repro_torch runs them
    argv = ["serve", "--arch", cfg.name, "--continuous",
            "--requests", str(PATHS["n"]), "--rate", str(PATHS["rate"]),
            "--prompt-lens", ",".join(map(str, PATHS["prompt_lens"])),
            "--max-new", str(PATHS["max_new_range"][1]),
            "--slots", str(PATHS["num_slots"]), "--block-size", str(BS),
            "--num-blocks", str(pool_blocks), "--seed", str(PATHS["seed"]),
            "--modules", "scan,metrics"]
    if PATHS["max_new_range"][0] != max(1, PATHS["max_new_range"][1] // 4):
        raise AssertionError("the CLI derives max_new's lower end as max_new // 4")
    for name, extra, direct in (
            ("session chunked", ["--chunked-prefill"], chunked),
            ("session spec ngram", ["--spec-decode", "--spec-k", str(SPEC_K)], spec),
            ("session scope gathered",
             ["--requests", str(SCOPE_REQUESTS), "--modules", "scan,metrics,scope",
              "--set", "scope.probes=final_hidden:stats"], None)):
        log(f"[{tag}] python -m repro_torch {' '.join(argv + extra)}")
        (session, (streams, met)), counts = _counted(
            torch, lambda: _session([*argv, *extra]))
        subset = specs[:SCOPE_REQUESTS] if direct is None else specs
        if met["finished"] != len(subset):
            raise AssertionError(f"{tag} {name}: not every request finished")
        _check_streams(name, cfg, subset, streams)
        _expect_launches(name, cfg, counts, session.tracer.events)
        _paths_metrics(name, met, session.tracer.events)
        res = session.results
        log(f"[{tag}] {name}: decode_path={res['decode_path']} "
            f"prefill_path={res['prefill_path']}")
        if direct is None:
            items = [it for s in res["stream_items"].values() for it in s]
            _check_stream_captures(torch, tag, items)
            log(f"[{tag}] {name}: scope report {res['scope']['captured']}")
        else:
            same = sum(streams[s.rid] == direct[s.rid] for s in specs)
            log(f"[{tag}] {name}: streams equal to the direct run's: {same} of "
                f"{len(specs)}")
            if name == "session chunked" and same != len(specs):
                raise AssertionError(f"{tag}: the Session's chunked streams differ "
                                     "from the direct run's")
        del session
        _free(torch)

    # (d) static serving through the Session against StaticRunner
    sargv = ["serve", "--arch", cfg.name, "--batch", str(STATIC["batch"]),
             "--prompt-len", str(STATIC["prompt_len"]), "--max-new",
             str(STATIC["max_new"]), "--seed", "0", "--modules", "scan,metrics"]
    log(f"[{tag}] python -m repro_torch {' '.join(sargv)}")
    (session, (gen, smet)), counts = _counted(torch, lambda: _session(sargv))
    _expect_launches("session static", cfg, counts, [], static_steps=STATIC["max_new"])
    static_prompts = session.results["static_prompts"]
    del session
    runner = StaticRunner(cfg, lm.init(cfg, seed=0, device="cuda"), device="cuda")
    (ref, rmet), rcounts = _counted(torch, lambda: runner.run(
        [(p, STATIC["max_new"], 0.0) for p in static_prompts],
        batch_size=STATIC["batch"]))
    _expect_launches("static runner", cfg, rcounts, [], static_steps=STATIC["max_new"])
    log(f"[{tag}] static: batch {STATIC['batch']} x prompt {STATIC['prompt_len']}, "
        f"{STATIC['max_new']} new: prefill_ms={1e3 * smet['prefill_s']:.2f} "
        f"decode_tok_s={smet['decode_tok_s']:.1f}; StaticRunner tokens_per_s="
        f"{rmet['tokens_per_s']:.2f}")
    if gen != [ref[i] for i in range(STATIC["batch"])]:
        raise AssertionError(f"{tag}: static serving's outputs differ from StaticRunner's")
    del runner, params
    _free(torch)
    return {"paged_prefill_verify": L * n_ver["verify"],
            "paged_prefill_chunk": L * n_chunk["prefill_chunk"]}


# ------------------------------------------------------------ route

# the route phase: MegaRoute over two replicas of the serve phase's model
# (qwen2-0.5b at full width and depth, seed-0 weights, bf16) on the serve
# phase's workload (SERVE: 32 Poisson requests at 40/s, prompts
# 128/512/2048, 16-64 new tokens, 8 slots of block 16 a replica)
ROUTE_REPLICAS = 2
ROUTE_POLICIES = ("jsq", "round_robin")


def _replica_counter(counts: dict):
    """A ``replica_wrap_steps`` entry: adds the paged kernels' and K1's
    launches inside this replica's engine steps to ``counts`` (the
    counters are process-wide, so a replica's share is what changes while
    its own steps run)."""
    from repro_torch.kernels import rmsnorm
    from repro_torch.kernels.paged_attention import launches

    def wrap(fn):
        def counted(*a, **kw):
            before = {**launches, **rmsnorm.launches}
            out = fn(*a, **kw)
            for k, v in {**launches, **rmsnorm.launches}.items():
                counts[k] = counts.get(k, 0) + v - before.get(k, 0)
            return out

        return counted

    return wrap


def _timed_steps(router) -> list:
    """Host-clock seconds of each router tick that admitted or decoded
    (every replica's forwards of that tick, in series), as it runs."""
    ticks = []
    step = router.step

    def timed():
        t0 = time.perf_counter()
        out = step()
        if out["admitted"] or out["active"]:
            ticks.append(time.perf_counter() - t0)
        return out

    router.step = timed
    return ticks


def _lane_medians(events, rank: int) -> str:
    """Host-clock medians of lane ``rank``'s prefill scopes and decode
    ticks, the ticks split by whether the replica prefilled in the same
    step."""
    def med(d):
        return f"{1e3 * statistics.median(d):.3f} ms x{len(d)}" if d else "none"

    lane = [e for e in events if e.rank == rank]
    pre_steps = {e.args["step"] for e in lane if e.name == "prefill"}
    dec = [e for e in lane if e.name == "decode"]
    return (f"prefill {med([e.dur for e in lane if e.name == 'prefill'])}; decode "
            f"{med([e.dur for e in dec])} (in a step with a prefill "
            f"{med([e.dur for e in dec if e.args['step'] in pre_steps])}, without "
            f"{med([e.dur for e in dec if e.args['step'] not in pre_steps])})")


def _partings(torch, cfg, params, prompts, ref: dict, got: dict, what: str,
              tag: str) -> int:
    """How many streams of ``got`` equal ``ref``'s; a stream that parts is
    replayed plain along ``ref``'s tokens, and its top-2 logit margin at
    the first differing token must lie within ``LOGIT_TOL`` (a near-tie
    under other bf16 roundings).  Returns the equal count."""
    same = 0
    for rid, a in ref.items():
        b = got[rid]
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None and len(a) == len(b):
            same += 1
            continue
        if i is None:
            raise AssertionError(f"{tag}: rid {rid} streams of {len(a)} and {len(b)} tokens")
        lp = replay(torch, cfg, params, prompts[rid], a[:i + 1], plain=True)
        top2 = lp[i, :cfg.vocab_size].topk(2).values
        margin = (top2[0] - top2[1]).item()
        log(f"[{tag}] {what}: rid={rid} parts at token {i} ({a[i]} against {b[i]}); "
            f"plain top-2 margin there {margin:.4f} (tol {LOGIT_TOL})")
        if margin > LOGIT_TOL:
            raise AssertionError(f"{tag}: {what}: rid {rid} parts away from a near-tie")
    log(f"[{tag}] {what}: {same} of {len(ref)} streams equal")
    return same


def _route_round_trip(torch, cfg, scfg, tag: str) -> None:
    """``export_slot`` then ``import_slot`` into other blocks and another
    slot of a second pool, then exported back, on the card: the slot of a
    2048-token prompt after its first token (129 blocks at the serve
    pool's table width, padded with the null block), ``torch.equal`` on
    its blocks; each copy timed with CUDA events against its bytes (read
    once, written once) at the memory rate."""
    from repro_torch.models import lm
    from repro_torch.serve.paged_cache import PagedKVCache, PoolSpec, blocks_for

    dev = torch.device("cuda")
    M = scfg.max_blocks_per_slot
    spec = PoolSpec(num_slots=scfg.num_slots, num_blocks=2 * M + 1, block_size=BS,
                    max_blocks=M)
    gen = torch.Generator(device=dev).manual_seed(0)
    a, b = PagedKVCache(cfg, spec, dev), PagedKVCache(cfg, spec, dev)
    for kv in (a, b):
        lm.tree_map(lambda t: t.copy_(torch.randn(t.shape, generator=gen, device=dev)),
                    kv.pool)
    n = min(blocks_for(max(SERVE["prompt_lens"]) + 1, BS), M)

    def table():
        perm = torch.randperm(2 * M, generator=gen, device=dev)[:n] + 1
        return torch.cat([perm, perm.new_zeros(M - n)]).to(torch.int32)

    phys, phys2 = table(), table()
    bundle = a.export_slot(a.pool, phys, 3)
    b.import_slot(b.pool, bundle, phys2, 5)
    back = b.export_slot(b.pool, phys2, 5)
    torch.cuda.synchronize()
    for x, y in zip(lm.tree_leaves(bundle), lm.tree_leaves(back)):
        if not torch.equal(x[:, :n], y[:, :n]):
            raise AssertionError(f"{tag}: the export/import round trip is not exact")
    nbytes = sum(t.numel() * t.element_size() for t in lm.tree_leaves(bundle))
    ex_ms = cuda_ms(lambda: a.export_slot(a.pool, phys, 3), 20)
    im_ms = cuda_ms(lambda: b.import_slot(b.pool, bundle, phys2, 5), 20)
    bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[{tag}] export/import round trip on the card: {n} blocks of a "
        f"{max(SERVE['prompt_lens'])}-token prompt in a {M}-block bundle of {nbytes} B, torch.equal; export "
        f"{ex_ms:.4f} ms ({2 * nbytes / ex_ms / 1e6:.1f} GB/s read + write), import "
        f"{im_ms:.4f} ms ({2 * nbytes / im_ms / 1e6:.1f} GB/s), bound {bound:.4f} ms "
        f"each (CUDA events, 20 calls)")


def route_phase(torch, smi: str, cfg, specs, prompts, single: dict, single_events,
                tag: str = "route") -> None:
    """MegaRoute on the card: ``Router`` over two MegaServe replicas of the
    serve phase's model (seed 0, bf16) and workload, 8 slots a replica.
    The weights are cast once and shared: one replica's resident and peak
    memory against two replicas', whose difference must be about one pool
    (another weight copy would add 0.99 GB).  Colocated under each of
    :data:`ROUTE_POLICIES`, then disaggregated (replica 0 prefill-only).
    Gates: every request finishes with a valid stream; the fleet's K4, K3
    and K1 launches equal what its merged events say, and each replica's
    (counted inside its own engine steps) what its lane says, so the
    disaggregated run launches K4 on replica 0 alone (24 x 32) and K3 on
    replica 1 alone; 32 migrations; streams against ``single`` (the serve
    phase's single engine) and the disaggregated ones against the jsq
    run's, a stream that parts only at a near-tie (``_partings``); the jsq
    streams teacher-forced, kernels against plain, within ``LOGIT_TOL``;
    the on-card export/import round trip; then ``serve --continuous
    --replicas 2 --router-policy jsq --traffic bursty`` through
    ``Session``: its router and replica series, route events and three
    lanes.  ``single_events`` (the serve phase's trace) give the single
    engine's prefill and decode medians beside the replicas'."""
    from repro_torch.models import lm
    from repro_torch.serve.paged_cache import pow2_bucket
    from repro_torch.serve.router import Router, RouterConfig
    from repro_torch.serve.server import MegaServe, make_poisson_workload

    L = cfg.num_layers
    scfg = make_poisson_workload(cfg, **SERVE)[2]
    M = scfg.max_blocks_per_slot
    log(f"[{tag}] the single engine (serve phase): {_lane_medians(single_events, 0)}")
    params = lm.init(cfg, seed=0, device="cuda")
    per = {name: [{} for _ in range(ROUTE_REPLICAS)]
           for name in (*ROUTE_POLICIES, "disaggregated")}

    def make(name, **rkw):
        return Router(cfg, params, scfg, RouterConfig(replicas=ROUTE_REPLICAS, **rkw),
                      device="cuda",
                      replica_wrap_steps=[_replica_counter(c) for c in per[name]])

    def built(fn):
        """``fn()``'s server, the bytes it holds once built and its peak over
        a warm-up of one request a prompt length (2 tokens each), above what
        was allocated before; the warm-up is then forgotten."""
        _free(torch)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        srv = fn()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        for n in sorted({s.prompt_len for s in specs}):
            srv.submit(prompts[0][:1] * n, 2, arrival=0.0)
        srv.drain()
        srv.reset()
        torch.cuda.synchronize()
        return srv, held, torch.cuda.max_memory_allocated() - base

    one, held1, peak1 = built(lambda: MegaServe(cfg, params, scfg, device="cuda"))
    pool_bytes = sum(t.numel() * t.element_size() for t in lm.tree_leaves(one.pool))
    # the caching allocator rounds each large tensor up to 2 MiB
    slack = 2 * 2**20 * len(lm.tree_leaves(one.pool))
    weight_bytes = sum(t.numel() * t.element_size() for t in lm.tree_leaves(one.params))
    del one
    router, held2, peak2 = built(lambda: make("jsq", policy="jsq"))
    shared = all(x is y for x, y in zip(*(lm.tree_leaves(r.params)
                                          for r in router.replicas)))
    log(f"[{tag}] {cfg.name} {L} layers, {ROUTE_REPLICAS} replicas x {scfg.num_slots} "
        f"slots, {scfg.num_blocks} blocks x {BS} each, table width {M}; weights "
        f"{weight_bytes} B, one pool {pool_bytes} B ({pool_bytes // scfg.num_blocks} B "
        f"a block); held once built: one replica {held1} B, two {held2} B; peak over "
        f"the warm-up: one {peak1} B, two {peak2} B; two minus one: held "
        f"{held2 - held1} B, peak {peak2 - peak1} B; replicas share the weight "
        f"tensors: {shared} ({smi})")
    if (not shared or not 0 <= held2 - held1 - pool_bytes <= slack
            or peak2 - peak1 > pool_bytes + weight_bytes // 2):
        raise AssertionError(f"{tag}: two replicas hold more than one pool beyond one "
                             "replica: the weights are not shared")
    # Router.precompile(): every replica's ladders (decode and prefill, one
    # variant a table-width bucket each), the launch counts left as they were
    from repro_torch.kernels import rmsnorm
    from repro_torch.kernels.paged_attention import launches

    before = {**launches, **rmsnorm.launches}
    rep = router.precompile()
    ladder = len(router.replicas[0]._width_ladder(M))
    log(f"[{tag}] Router.precompile: {_precompiled(rep)}")
    if (rep["total"] != ROUTE_REPLICAS * 2 * ladder
            or {**launches, **rmsnorm.launches} != before):
        raise AssertionError(f"{tag}: Router.precompile walked {rep['total']} variants, "
                             f"not {ROUTE_REPLICAS} x 2 x {ladder}, or moved the counts")

    def run(name, router):
        ticks = _timed_steps(router)
        for c in per[name]:
            c.clear()  # the warm-up's launches
        for s in specs:
            if router.submit(prompts[s.rid], s.max_new, arrival=s.arrival) != s.rid:
                raise AssertionError(f"{tag}: the router numbered requests otherwise")
        torch.cuda.reset_peak_memory_stats()
        streams, counts = _counted(torch, router.drain)
        met, events = router.metrics(), router.trace_events()
        if met["finished"] != len(specs) or met["shed"]:
            raise AssertionError(f"{tag} {name}: {met['finished']} of {len(specs)} "
                                 f"requests finished, {met['shed']} shed")
        _check_streams(name, cfg, specs, streams)
        _expect_launches(name, cfg, counts, events, phase=tag)
        for i, got in enumerate(per[name]):
            n_pre = sum(e.name == "prefill" and e.rank == i for e in events)
            n_dec = sum(e.name == "decode" and e.rank == i for e in events)
            want = {"paged_prefill": L * n_pre, "paged_decode": L * n_dec,
                    "rmsnorm_fwd": (2 * L + 1) * (n_pre + n_dec)}
            got = {k: got.get(k, 0) for k in want}
            log(f"[{tag}] {name}: replica {i}: {n_pre} prefills, {n_dec} decode ticks; "
                f"launches {got}, expected {want}")
            if got != want:
                raise AssertionError(f"{tag} {name}: replica {i} launches {got} != {want}")
            log(f"[{tag}] {name}: replica {i}: {_lane_medians(events, i)}")
        log(f"[{tag}] {name}: tokens_per_s={met['tokens_per_s']:.2f} "
            f"ttft_p50_s={met['ttft_p50_s']:.4f} ttft_p99_s={met['ttft_p99_s']:.4f} "
            f"queue_wait_p99_s={met['queue_wait_p99_s']:.4f} "
            f"latency_p50_s={met['latency_p50_s']:.4f} "
            f"latency_p99_s={met['latency_p99_s']:.4f} wall_s={met['wall_s']:.3f} "
            f"placed_per_replica={met['placed_per_replica']} "
            f"replica_tokens={met['replica_tokens']} load_skew={met['load_skew']:.4f} "
            f"migrations={met['migrations']} preemptions={met['preemptions']}; router "
            f"tick median {1e3 * statistics.median(ticks):.3f} ms over {len(ticks)} "
            f"ticks; peak memory over the run {torch.cuda.max_memory_allocated()} B "
            f"({smi})")
        return streams, met, events

    out = {}
    for policy in ROUTE_POLICIES:
        if router is None:
            router = make(policy, policy=policy)
        streams, met, _ = run(policy, router)
        if min(met["placed_per_replica"]) == 0:
            raise AssertionError(f"{tag} {policy}: a replica served nothing")
        _partings(torch, cfg, router.replicas[0].params, prompts, single, streams,
                  f"{policy} against the single engine", tag)
        if policy == "jsq":
            teacher_forced(torch, cfg, router.replicas[0], specs, prompts, streams,
                           tag=f"{tag}-check")
        out[policy] = streams
        router = None
        _free(torch)

    router = make("disaggregated", policy="jsq", prefill_replicas=1)
    streams, met, events = run("disaggregated", router)
    n_pre = [sum(e.name == "prefill" and e.rank == i for e in events) for i in (0, 1)]
    n_dec = [sum(e.name == "decode" and e.rank == i for e in events) for i in (0, 1)]
    if (met["migrations"] != len(specs) or n_pre != [len(specs), 0] or n_dec[0]
            or not n_dec[1]):
        raise AssertionError(f"{tag} disaggregated: {met['migrations']} migrations, "
                             f"prefills {n_pre}, decode ticks {n_dec}")
    k = per["disaggregated"]
    log(f"[{tag}] disaggregated: K4 on replica 0 {k[0]['paged_prefill']} "
        f"(= {L} x {len(specs)}), on replica 1 {k[1].get('paged_prefill', 0)}; K3 on "
        f"replica 0 {k[0].get('paged_decode', 0)}, on replica 1 {k[1]['paged_decode']}")
    if (k[0]["paged_prefill"] != L * len(specs) or k[1].get("paged_prefill", 0)
            or k[0].get("paged_decode", 0)):
        raise AssertionError(f"{tag} disaggregated: K4 or K3 launched on the wrong replica")
    block_bytes = pool_bytes // scfg.num_blocks
    for name in ("kv_export", "kv_import"):
        evs = [e for e in events if e.name == name]
        nbytes = [min(pow2_bucket(e.args["blocks"]), M) * block_bytes for e in evs]
        rates = [b / e.dur / 1e9 for b, e in zip(nbytes, evs)]
        log(f"[{tag}] disaggregated: {name} x{len(evs)}: median "
            f"{1e3 * statistics.median(e.dur for e in evs):.4f} ms, max "
            f"{1e3 * max(e.dur for e in evs):.4f} ms (host clock, the scope waits for "
            f"the card); bundles {min(nbytes)}-{max(nbytes)} B; median "
            f"{statistics.median(rates):.1f} GB/s, at the largest bundle "
            f"{max(zip(nbytes, rates))[1]:.1f} GB/s")
    _partings(torch, cfg, router.replicas[0].params, prompts, out["jsq"], streams,
              "disaggregated against colocated jsq", tag)
    router = None
    del params
    _free(torch)
    _route_round_trip(torch, cfg, scfg, tag)
    _free(torch)

    # the Session: python -m repro_torch serve ... --replicas 2 --traffic bursty
    argv = ["serve", "--arch", cfg.name, "--continuous",
            "--requests", str(SERVE["n"]), "--rate", str(SERVE["rate"]),
            "--prompt-lens", ",".join(map(str, SERVE["prompt_lens"])),
            "--max-new", str(SERVE["max_new_range"][1]),
            "--slots", str(SERVE["num_slots"]), "--block-size", str(BS),
            "--seed", str(SERVE["seed"]), "--replicas", str(ROUTE_REPLICAS),
            "--router-policy", "jsq", "--traffic", "bursty", "--modules", "scan,metrics"]
    log(f"[{tag}] python -m repro_torch {' '.join(argv)}")
    (session, (streams, met)), counts = _counted(torch, lambda: _session(argv))
    bspecs = make_poisson_workload(cfg, **SERVE, traffic="bursty")[0]
    events = session.tracer.events
    snap = session.metrics_registry.snapshot()
    lanes = sorted({e.rank for e in events if e.kind != "counter"})
    n_route = sum(e.name == "route" for e in events)
    series = sorted({k.split(".")[1] for k in snap if k.startswith("serve.r")})
    log(f"[{tag}] session bursty jsq: serve_config {session.results['serve_config']}; "
        f"router series {sorted(k for k in snap if k.startswith('router.'))}; replica "
        f"series prefixes {series}; lanes {lanes}; {n_route} route events")
    if met["finished"] != len(bspecs):
        raise AssertionError(f"{tag}: the Session's routed run did not finish every request")
    _check_streams("session bursty jsq", cfg, bspecs, streams)
    _expect_launches("session bursty jsq", cfg, counts, events, phase=tag)
    if (snap.get("router.placed") != len(bspecs) or series != ["r0", "r1"]
            or lanes != [0, 1, 2] or n_route != len(bspecs)):
        raise AssertionError(f"{tag}: the Session's routed run lacks its router series, "
                             "replica series, lanes or route events")
    ticks = [e.dur for e in events if e.name == "decode"]
    log(f"[{tag}] session bursty jsq: tokens_per_s={met['tokens_per_s']:.2f} "
        f"ttft_p50_s={met['ttft_p50_s']:.4f} ttft_p99_s={met['ttft_p99_s']:.4f} "
        f"queue_wait_p99_s={met['queue_wait_p99_s']:.4f} "
        f"latency_p99_s={met['latency_p99_s']:.4f} "
        f"placed_per_replica={met['placed_per_replica']} "
        f"load_skew={met['load_skew']:.4f} wall_s={met['wall_s']:.3f}; replica decode "
        f"tick median {1e3 * statistics.median(ticks):.3f} ms over {len(ticks)}")
    del session
    _free(torch)


def _check_stream_captures(torch, tag: str, items) -> None:
    """Every stream token carries a finite ``final_hidden`` stats capture."""
    import numpy as np

    bad = [it.step for it in items
           if not all(np.isfinite(v).all()
                      for v in it.captures.get("top", {}).get("final_hidden.stats",
                                                               {None: [np.nan]}).values())]
    log(f"[{tag}] {len(items)} stream tokens, {len(items) - len(bad)} with a finite "
        f"final_hidden capture")
    if not items or bad:
        raise AssertionError(f"{tag}: tokens without a final_hidden capture: {bad[:8]}")


def replay(torch, cfg, params, prompt, forced, *, plain):
    """Teacher-forced logits ``[len(forced), V]``: prefill ``prompt``, then
    decode ``forced[:-1]`` one token at a time, in a pool of its own.  An
    attention-only family prefills through the flash-prefill step; a
    recurrent one as MegaServe does, the prompt's pow2 segments over a
    dense cache of the bucketed length (capped at the table width) then
    scattered into the pool's blocks and state row."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import (
        make_flash_prefill_step, make_paged_decode_step, make_seg_prefill)
    from repro_torch.serve.paged_cache import (
        PagedKVCache, PoolSpec, blocks_for, pow2_bucket, pow2_segments)

    dev = torch.device("cuda")
    n_blk = blocks_for(len(prompt) + len(forced), BS)
    p_blk = blocks_for(len(prompt), BS)
    table = torch.arange(1, n_blk + 1, dtype=torch.int32, device=dev)[None]
    decode = make_paged_decode_step(cfg, block_size=BS, plain=plain)
    if all(lm.tree_leaves(lm.paged_flags(cfg))):
        pool = lm.init_pool(cfg, n_blk + 1, BS, dev)
        prefill = make_flash_prefill_step(cfg, block_size=BS, plain=plain)
        toks = torch.tensor([prompt + [0] * (p_blk * BS - len(prompt))], device=dev)
        out = [prefill(params, pool, table[:, :p_blk].contiguous(), toks, len(prompt))[0]]
    else:
        kv = PagedKVCache(cfg, PoolSpec(num_slots=1, num_blocks=n_blk + 1, block_size=BS,
                                        max_blocks=n_blk), dev)
        pool = kv.pool
        bucket = min(pow2_bucket(p_blk), n_blk)
        cache = lm.init_cache(cfg, 1, bucket * BS, device=dev)
        seg = make_seg_prefill(cfg, plain=plain)
        toks, off = torch.tensor([prompt], device=dev), 0
        for w in pow2_segments(len(prompt)):
            logits, _ = seg(params, cache, toks[:, off:off + w], off)
            off += w
        kv.scatter_prefill(pool, cache, 0, table[0, :bucket])
        del cache
        out = [logits]
    for i, tok in enumerate(forced[:-1]):
        pos = torch.tensor([len(prompt) + i], dtype=torch.int32, device=dev)
        out.append(decode(params, pool, table, torch.tensor([tok], device=dev), pos)[0][0])
    return torch.stack(out).float()


class _Float64Norms:
    """Within it, the model's plain RMSNorm takes its float32 internals in
    float64 before its one rounding to the compute dtype: the same function
    rounded another valid way, no kernel involved (the noise probe of
    :func:`teacher_forced`)."""

    def __enter__(self):
        from repro_torch.models import layers

        self.layers, self.inner = layers, layers.rmsnorm

        def norm(x, scale, eps, plain=False):
            if not plain:
                return self.inner(x, scale, eps, plain=False)
            xd = x.double()
            y = xd * (xd * xd).mean(-1, keepdim=True).add(eps).rsqrt() * scale.double()
            return y.to(x.dtype)

        layers.rmsnorm = norm
        return self

    def __exit__(self, *exc):
        self.layers.rmsnorm = self.inner


class _PinnedRouting:
    """Within it, the MoE router's top-k (``models.layers._top_k``) records
    the experts each call picks; after :meth:`replay` each call takes the
    experts of the recorded call of the same rank instead (the same
    forwards in the same order: layer by layer, a remat recompute included)
    at its own probabilities, and counts the token routings whose own top-k
    set differs from the pinned one (``flips``, of ``routings``).  It holds
    a kernel path and the plain path to one routing, so a bfloat16 near-tie
    that one ulp tips (a discontinuity of the model, not of a kernel) does
    not part their outputs (ROADMAP P15)."""

    def __enter__(self):
        from repro_torch.models import layers

        self.layers, self.inner = layers, layers._top_k
        self.picks, self.at, self.flips, self.routings = [], None, 0, 0

        def top_k(probs, k):
            vals, idx = self.inner(probs, k)
            if self.at is None:
                self.picks.append(idx)
                return vals, idx
            pin = self.picks[self.at]
            self.at += 1
            own = idx.sort(-1).values != pin.sort(-1).values
            self.flips = self.flips + own.any(-1).sum()
            self.routings += idx[..., 0].numel()
            return probs.gather(-1, pin), pin

        layers._top_k = top_k
        return self

    def replay(self) -> None:
        self.at = 0

    def __exit__(self, *exc):
        self.layers._top_k = self.inner
        if exc[0] is None and self.at is not None and self.at != len(self.picks):
            raise AssertionError(f"pinned routing: {self.at} calls replayed "
                                 f"{len(self.picks)} recorded")
        self.flips = int(self.flips)


def _check_flips(tag: str, pin: _PinnedRouting, noise: _PinnedRouting,
                 what: str = "", above_noise: bool = False) -> None:
    """Holds the kernel path's routing flips (``pin``: the plain path pinned
    to the kernel path's routing) to ``MOE_FLIP_SHARE`` of the routings, the
    noise probe's (``noise``: the plain path under :class:`_Float64Norms`
    pinned to the plain path's) logged beside.  With ``above_noise``
    (deepseek-v2-lite, whose 64-expert router flips more than that at any
    change of rounding: see ``MOE_FLIP_SHARE``) the kernels' share less the
    noise probe's is held to it."""
    share = pin.flips / max(pin.routings, 1)
    floor = noise.flips / max(noise.routings, 1) if above_noise else 0.0
    ok = share - floor <= MOE_FLIP_SHARE
    held = (f"{share - floor:.4f} above the noise probe's" if above_noise
            else f"{share:.4f}")
    log(f"[{tag}] {what}routing flips, plain vs kernels: {pin.flips} of {pin.routings} token "
        f"routings ({held}, limit {MOE_FLIP_SHARE}); noise probe, plain with "
        f"float64 norms vs plain: {noise.flips} of {noise.routings} "
        f"({noise.flips / max(noise.routings, 1):.4f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: the kernels move {share:.4f} of the MoE routings")


def teacher_forced(torch, cfg, srv, specs, prompts, streams, tag: str = "check",
                   float32: bool = False, pin_routing: bool = False,
                   replay_fn=None, flips_above_noise: bool = False) -> None:
    """Replays one finished stream per prompt length teacher-forced through
    the kernels and through the plain versions: their logits must agree
    within ``LOGIT_TOL``, and each served token must lie within it of the
    plain path's largest logit.  With ``float32`` (the recurrent families,
    see ``LOGIT_TOL``) both replays compute in float32 over the served
    weights (K1 on float32 rows, K3 on float32 queries) and are held to
    ``LOGIT_TOL``; the bfloat16 replays are logged beside, with the noise
    probe (the plain path under :class:`_Float64Norms`) and the served
    tokens' gap, held to nothing.  With ``pin_routing`` (MoE) the plain
    replay routes every token to the experts the kernel replay picked
    (:class:`_PinnedRouting`), and the routings it would have picked
    otherwise are held to ``MOE_FLIP_SHARE`` (:func:`_check_flips`); the
    plain replay on its own routing is logged beside, with the noise probe
    pinned to it, held to nothing.  ``replay_fn`` replaces :func:`replay`
    (MLA: :func:`_dense_replay`, the gathered path's dense forward);
    ``flips_above_noise`` is :func:`_check_flips`' ``above_noise``."""
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.kernels.paged_attention import launches
    from repro_torch.models import lm

    rerun = replay_fn or replay

    picked = {}
    for s in specs:  # one finished stream per prompt length
        picked.setdefault(s.prompt_len, s)
    before = {**launches, **rmsnorm.launches, **flash_attention.launches}
    V = cfg.vocab_size
    cfg32 = cfg.replace(compute_dtype="float32")
    params32 = lm.tree_map(lambda t: t.float(), srv.params) if float32 else None
    for plen, s in sorted(picked.items()):
        forced, prompt = streams[s.rid], prompts[s.rid]
        if pin_routing:
            with _PinnedRouting() as pin:
                lk = rerun(torch, cfg, srv.params, prompt, forced, plain=False)
                pin.replay()
                lp = rerun(torch, cfg, srv.params, prompt, forced, plain=True)
            with _PinnedRouting() as noise:
                free = rerun(torch, cfg, srv.params, prompt, forced, plain=True)
                noise.replay()
                with _Float64Norms():
                    lq = rerun(torch, cfg, srv.params, prompt, forced, plain=True)
            log(f"[{tag}] rid={s.rid} prompt={plen} plain path on its own routing, "
                f"held to nothing: max_logit_err={(lk - free)[:, :V].abs().max().item():.4f} "
                f"noise_probe={(lq - free)[:, :V].abs().max().item():.4f} (pinned to it)")
            _check_flips(tag, pin, noise, f"rid={s.rid} prompt={plen} ",
                         above_noise=flips_above_noise)
            del free, lq
        else:
            lk = rerun(torch, cfg, srv.params, prompt, forced, plain=False)
            lp = rerun(torch, cfg, srv.params, prompt, forced, plain=True)
        err = (lk[:, :V] - lp[:, :V]).abs().max().item()
        idx = torch.tensor(forced, device=lp.device)[:, None]
        gap = (lp[:, :V].max(-1).values - lp.gather(1, idx)[:, 0]).max().item()
        agree = (lk[:, :V].argmax(-1) == lp[:, :V].argmax(-1)).float().mean().item()
        if float32:
            with _Float64Norms():
                lq = rerun(torch, cfg, srv.params, prompt, forced, plain=True)
            probe = (lq[:, :V] - lp[:, :V]).abs().max().item()
            log(f"[{tag}] rid={s.rid} prompt={plen} bfloat16, held to nothing: "
                f"max_logit_err={err:.4f} noise_probe={probe:.4f} "
                f"max_gap_to_plain_max={gap:.4f} argmax_agree={agree:.3f}")
            lk = rerun(torch, cfg32, params32, prompt, forced, plain=False)
            lp = rerun(torch, cfg32, params32, prompt, forced, plain=True)
            err = (lk[:, :V] - lp[:, :V]).abs().max().item()
            agree = (lk[:, :V].argmax(-1) == lp[:, :V].argmax(-1)).float().mean().item()
            gap = 0.0
        ok = err <= LOGIT_TOL and gap <= LOGIT_TOL and torch.isfinite(lk).all()
        log(f"[{tag}] rid={s.rid} prompt={plen} steps={len(forced)} "
            f"{'float32 ' if float32 else ''}max_logit_err={err:.4f} "
            f"max_gap_to_plain_max={gap:.4f} argmax_agree={agree:.3f} tol={LOGIT_TOL} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: teacher-forced check failed for rid {s.rid}")
    if {**launches, **rmsnorm.launches, **flash_attention.launches} == before:
        raise AssertionError(f"{tag}: the kernel-path replay launched no kernel")


def profile_decode_tick(torch, cfg, params, ticks: int = 5, kv_lens=TICK_KV_LENS,
                        M: int = 132, tag: str = "tick", gathered: bool = False) -> None:
    """One decode tick (``make_paged_decode_step`` and the read-back of the
    next tokens; with ``gathered``, the gathered path's ``PagedKVCache.gather``,
    one B=1 forward a slot and ``scatter_decode``) at a timing shape, 8 slots
    at ``kv_lens`` (table width ``M``; the recurrent families' state rows
    ride along): host ms per tick by the host clock, then under
    ``torch.profiler`` the kernels a tick runs and their summed device time;
    the rest of the tick the device waits for the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import make_paged_decode_step, make_slot_decode_step
    from repro_torch.serve.paged_cache import PagedKVCache, PoolSpec

    dev = torch.device("cuda")
    kv = PagedKVCache(cfg, PoolSpec(num_slots=8, num_blocks=1 + 8 * M, block_size=BS,
                                    max_blocks=M), dev)
    tables = (1 + torch.arange(8 * M, dtype=torch.int32, device=dev)).reshape(8, M)
    toks = torch.zeros(8, dtype=torch.long, device=dev)
    pos = torch.tensor([n - 1 for n in kv_lens], dtype=torch.int32, device=dev)
    if gathered:
        step = make_slot_decode_step(cfg)

        def decode():
            dense = kv.gather(kv.pool, tables)
            logits, _ = step(params, dense, toks, pos)
            kv.scatter_decode(kv.pool, dense, tables, pos)
            return logits
    else:
        step = make_paged_decode_step(cfg, block_size=BS)

        def decode():
            return step(params, kv.pool, tables, toks, pos)[0]

    def tick():
        return decode().argmax(-1).tolist()

    for _ in range(3):
        tick()
    host = []
    for _ in range(2 * ticks):
        t0 = time.perf_counter()
        tick()
        host.append(time.perf_counter() - t0)
    host_ms = 1e3 * statistics.median(host)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            tick()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"[{tag}] the profiler recorded no device time: device busy share not measured")
        return
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / ticks
    what = "gathered decode tick (8 B=1 slot forwards)" if gathered else "decode tick"
    log(f"[{tag}] {cfg.name} {what} at kv_len={kv_lens}: host {host_ms:.3f} ms "
        f"(median of {2 * ticks}); device busy {busy_ms:.3f} ms in "
        f"{len(kernels) / ticks:.0f} kernels (torch.profiler, {ticks} ticks); device idle "
        f"share {1 - busy_ms / host_ms:.3f}")


def serve_recurrent(torch, dev, arch: str, shape: dict, smi: str,
                    min_table: int = 0, layers: int | None = None) -> dict:
    """MegaServe on a recurrent family at full width, its depth cut to
    ``layers`` when given (seed-0 weights, bf16): ``shape``'s Poisson
    workload, every request finished
    with a valid stream; K1 launched exactly once a norm a forward, each
    decode tick one forward and each prefill one a pow2 segment of its
    tokens (``(2L + 1) x (ticks + sum of popcount(tokens))``); K3 once an
    attention layer a tick; no K1 backward, K4, K5 or K6 (a carried state
    goes to the plain recurrences); teacher-forced logits of one stream per
    prompt length through the kernels and through the plain versions
    within ``LOGIT_TOL``; tokens/s, TTFT, the median tick, peak memory and
    one tick's host and device time.  ``min_table`` widens the block
    table (and the pool) to at least that many blocks a slot.  Returns the
    launch counts."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels import rglru, rmsnorm, wkv6
    from repro_torch.kernels.paged_attention import launches, reset_launches
    from repro_torch.models import lm
    from repro_torch.models.model import count_params
    from repro_torch.serve.server import MegaServe, make_poisson_workload

    cfg = get_config(arch)
    tag = f"serve-{cfg.family}"
    if layers is not None:
        log(f"[{tag}] depth cut: {layers} of {cfg.num_layers} layers, full width")
        cfg = cfg.replace(num_layers=layers)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init(cfg, seed=0, device="cuda")
    n_params = count_params(params)
    specs, prompts, scfg = make_poisson_workload(cfg, **shape)
    if scfg.max_blocks_per_slot < min_table:
        scfg = replace(scfg, max_blocks_per_slot=min_table,
                       num_blocks=scfg.num_slots * min_table + 1)
    srv = MegaServe(cfg, params, scfg, device="cuda")
    del params  # the server keeps its bf16 copy; the float32 tree goes
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    kinds = [k for pat, n in lm.segment_layout(cfg) for _ in range(n) for k in pat]
    n_attn = kinds.count("attn")
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers ({n_attn} attention) d_model="
        f"{cfg.d_model} vocab={cfg.padded_vocab}, {n_params} parameters; "
        f"{scfg.num_slots} slots, {scfg.num_blocks} blocks x {scfg.block_size}, table "
        f"width {scfg.max_blocks_per_slot}; prefill_path={srv.prefill_path}; set-up "
        f"{time.perf_counter() - t0:.2f} s, peak {init_peak} B (float32 init + bf16 cast)")
    srv.submit(prompts[0][:33], 2, arrival=0.0)  # warm-up: segments 32 + 1
    srv.drain()
    srv.reset()
    torch.cuda.reset_peak_memory_stats()

    mods = (rmsnorm, wkv6, rglru)
    reset_launches()
    for m in mods:
        m.reset_launches()
    for s in specs:
        srv.submit(prompts[s.rid], s.max_new, arrival=s.arrival, rid=s.rid)
    streams = srv.drain()
    torch.cuda.synchronize()
    counts = {**launches, **{k: v for m in mods for k, v in m.launches.items()}}
    met = srv.metrics()
    events = srv.trace_events()
    ticks = [e.dur for e in events if e.name == "decode"]
    prefills = [e.args["tokens"] for e in events if e.name == "prefill"]
    segs = sum(bin(n).count("1") for n in prefills)
    by_len: dict[int, list[float]] = {}
    for e in events:
        if e.name == "prefill":
            by_len.setdefault(e.args["tokens"], []).append(e.dur)
    prefill_ms = ", ".join(f"{n} tokens {1e3 * statistics.median(d):.1f} ms"
                           for n, d in sorted(by_len.items()))
    L = cfg.num_layers
    want = {"paged_decode": len(ticks) * n_attn, "rmsnorm_fwd": (2 * L + 1) * (len(ticks) + segs)}
    log(f"[{tag}] finished={met['finished']}/{len(specs)} tokens={met['generated_tokens']} "
        f"tokens_per_s={met['tokens_per_s']:.2f} ttft_p50_s={met['ttft_p50_s']:.4f} "
        f"ttft_p99_s={met['ttft_p99_s']:.4f} decode_tick_median_ms="
        f"{1e3 * statistics.median(ticks):.3f} ticks={len(ticks)} prefills={len(prefills)} "
        f"({segs} segments) preemptions={met['preemptions']} wall_s={met['wall_s']:.3f} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} ({smi})")
    log(f"[{tag}] prefill, median on the host clock: {prefill_ms}")
    log(f"[{tag}] launches {counts}; expected paged_decode {len(ticks)}x{n_attn}="
        f"{want['paged_decode']}, rmsnorm_fwd (2x{L}+1)x({len(ticks)}+{segs})="
        f"{want['rmsnorm_fwd']}, every other 0")
    if any(counts[k] != want.get(k, 0) for k in counts) or not counts["rmsnorm_fwd"] or (
            n_attn and not counts["paged_decode"]):
        raise AssertionError(f"{tag}: launches {counts} != {want}")
    if met["finished"] != len(specs):
        raise AssertionError(f"{tag}: not every request finished")
    for s in specs:
        toks = streams[s.rid]
        if len(toks) != s.max_new or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{tag}: request {s.rid}: bad stream {toks[:8]}...")
    teacher_forced(torch, cfg, srv, specs, prompts, streams, tag, float32=True)
    if n_attn:
        profile_decode_tick(torch, cfg, srv.params, kv_lens=GRIFFIN_TICK_KV_LENS,
                            M=GRIFFIN_TICK_M, tag=tag)
    else:
        profile_decode_tick(torch, cfg, srv.params, tag=tag)
    del srv
    gc.collect()  # the server's clock closure holds it in a cycle
    torch.cuda.empty_cache()
    return counts


class _DropFracs:
    """Within it, every MoE layer's ``moe_drop_frac`` (``models.layers.
    moe_apply``'s), kept on the device by the kind of forward: ``prefill``
    (more than one token a row) or ``decode``."""

    def __enter__(self):
        from repro_torch.models import layers

        self.layers, self.inner = layers, layers.moe_apply
        self.fracs: dict[str, list] = {"prefill": [], "decode": []}

        def moe_apply(p, cfg, x, **kw):
            y, aux = self.inner(p, cfg, x, **kw)
            self.fracs["prefill" if x.shape[1] > 1 else "decode"].append(
                aux["moe_drop_frac"])
            return y, aux

        layers.moe_apply = moe_apply
        return self

    def __exit__(self, *exc):
        self.layers.moe_apply = self.inner

    def __str__(self):
        return "; ".join(
            f"{k}: mean {sum(float(f) for f in v) / len(v):.4f}, max "
            f"{max(float(f) for f in v):.4f} over {len(v)} layer calls"
            for k, v in self.fracs.items() if v)


def serve_config(torch, arch: str, smi: str, layers: int | None = None) -> dict:
    """MegaServe on a dense or MoE config at full width (seed-0 weights,
    bf16; ``layers`` cuts the depth): ``CONFIG_SERVE``'s 12 Poisson
    requests, every request finished with a valid stream; each prompt
    launches K4 once a layer, each decode tick K3 once a layer, each forward
    K1 once a norm (2L + 1), nothing a K1 backward; the teacher-forced logits
    of one stream per prompt length, kernels against plain, within
    ``LOGIT_TOL`` (an MoE's plain replay pinned to the kernel replay's
    routing, :class:`_PinnedRouting`); tokens/s, TTFT p50/p99, the median
    tick, one tick's host and device time, peak memory and, for MoE, each
    path's ``moe_drop_frac``.  The float32 init is freed once the server
    holds its bf16 copy.  Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.model import count_params
    from repro_torch.serve.server import MegaServe, make_poisson_workload

    cfg = get_config(arch)
    full = cfg.num_layers
    if layers:
        cfg = cfg.replace(num_layers=layers)
    moe = cfg.family == "moe"
    tag = "serve-moe" if moe else f"serve-{arch.split('-')[0]}"
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init(cfg, seed=0, device="cuda")
    n_params = count_params(params)
    specs, prompts, scfg = make_poisson_workload(cfg, **CONFIG_SERVE)
    srv = MegaServe(cfg, params, scfg, device="cuda")
    del params  # the server keeps its bf16 copy; the float32 tree goes
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    _free(torch)
    H_, K_ = cfg.num_heads, cfg.num_kv_heads
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} of {full} layers d_model={cfg.d_model} "
        f"heads={H_}/{K_} (G={H_ // K_}) dh={cfg.head_dim} vocab={cfg.padded_vocab} "
        f"mlp={cfg.mlp_kind}{f', {cfg.moe.num_experts} experts top-{cfg.moe.top_k}' if moe else ''}, "
        f"{n_params} parameters; {scfg.num_slots} slots, {scfg.num_blocks} blocks x "
        f"{scfg.block_size}, table width {scfg.max_blocks_per_slot}; "
        f"prefill_path={srv.prefill_path}; set-up {time.perf_counter() - t0:.2f} s, peak "
        f"{init_peak} B (float32 init + bf16 cast), held after {torch.cuda.memory_allocated()} B")
    for n in sorted({s.prompt_len for s in specs}):  # warm-up
        srv.submit(prompts[0][:1] * n, 2, arrival=0.0)
    srv.drain()
    srv.reset()
    torch.cuda.reset_peak_memory_stats()

    def run():
        for s in specs:
            srv.submit(prompts[s.rid], s.max_new, arrival=s.arrival, rid=s.rid)
        return srv.drain()

    with _DropFracs() as drops:
        streams, counts = _counted(torch, run)
    met = srv.metrics()
    events = srv.trace_events()
    ticks = [e.dur for e in events if e.name == "decode"]
    n_prefill = sum(e.name == "prefill" for e in events)
    L = cfg.num_layers
    want = {"paged_prefill": L * n_prefill, "paged_decode": L * len(ticks),
            "rmsnorm_fwd": (2 * L + 1) * (len(ticks) + n_prefill), "rmsnorm_bwd": 0}
    log(f"[{tag}] finished={met['finished']}/{len(specs)} tokens={met['generated_tokens']} "
        f"tokens_per_s={met['tokens_per_s']:.2f} ttft_p50_s={met['ttft_p50_s']:.4f} "
        f"ttft_p99_s={met['ttft_p99_s']:.4f} decode_tick_median_ms="
        f"{1e3 * statistics.median(ticks):.3f} ticks={len(ticks)} prefills={n_prefill} "
        f"preemptions={met['preemptions']} wall_s={met['wall_s']:.3f} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} ({smi})")
    log(f"[{tag}] launches {counts}, expected {want}")
    if moe:
        log(f"[{tag}] moe_drop_frac by path: {drops}")
    if counts != want or not (want["paged_prefill"] and want["paged_decode"]):
        raise AssertionError(f"{tag}: launches {counts} != {want}")
    if met["finished"] != len(specs):
        raise AssertionError(f"{tag}: not every request finished")
    for s in specs:
        toks = streams[s.rid]
        if len(toks) != s.max_new or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{tag}: request {s.rid}: bad stream {toks[:8]}...")
    teacher_forced(torch, cfg, srv, specs, prompts, streams, tag, pin_routing=moe)
    profile_decode_tick(torch, cfg, srv.params, tag=tag)
    del srv
    _free(torch)
    return counts


def serve_mla(torch, smi: str) -> dict:
    """MegaServe on deepseek-v2-lite-16b at full width, depth cut to
    ``MLA_SERVE_LAYERS`` (seed-0 weights drawn leaf by leaf in bf16):
    ``CONFIG_SERVE``'s 12
    Poisson requests on the gathered path (the only one MLA's latent cache
    takes; the dense prefill), every request finished with a valid stream;
    launches exact: K1 3L + 1 a forward (ln1, ln2, the latent norm; every
    prefill and every slot's B=1 decode forward), K2's forward L a prefill
    whose padded length exceeds ``attn_kv_chunk``, nothing else (no K3, no
    K4, no backward); the teacher-forced logits of one stream per prompt
    length through the dense-cache forward at the served cache length,
    kernels against plain, within ``LOGIT_TOL`` with the plain replay
    routed as the kernel replay routed (:class:`_PinnedRouting`; the flips
    held to ``MOE_FLIP_SHARE`` above the noise probe's); tokens/s,
    TTFT p50/p99, the median tick, one tick's host and device time, peak
    memory and ``moe_drop_frac``.  Returns the launch counts."""
    from functools import partial

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.kernels import paged_attention as paged
    from repro_torch.models import lm
    from repro_torch.models.model import count_params
    from repro_torch.serve.server import MegaServe, make_poisson_workload

    tag = "serve-mla"
    cfg = get_config("deepseek-v2-lite-16b").replace(num_layers=MLA_SERVE_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    n_params = count_params(params)
    if n_params != MLA_SERVE_PARAMS:
        raise AssertionError(f"{tag}: {n_params} parameters, not {MLA_SERVE_PARAMS}")
    specs, prompts, scfg = make_poisson_workload(cfg, **CONFIG_SERVE)
    srv = MegaServe(cfg, params, scfg, device="cuda")
    del params  # the server's cast is the same tree
    m = cfg.mla
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model} heads="
        f"{cfg.num_heads} MLA rank {m.kv_lora_rank} q/k dh {m.qk_nope_head_dim}+"
        f"{m.qk_rope_head_dim} v dh {m.v_head_dim}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k} + {cfg.moe.num_shared_experts} shared, first "
        f"{cfg.moe.first_k_dense} dense; {n_params} parameters drawn in bf16 (peak "
        f"{init_peak} B); {scfg.num_slots} slots, {scfg.num_blocks} blocks x "
        f"{scfg.block_size}, table width {scfg.max_blocks_per_slot}; decode_path="
        f"{srv.decode_path} prefill_path={srv.prefill_path}; set-up "
        f"{time.perf_counter() - t0:.2f} s, held {torch.cuda.memory_allocated()} B")
    if (srv.decode_path, srv.prefill_path) != ("gathered", "dense"):
        raise AssertionError(f"{tag}: MLA served on {srv.decode_path}/{srv.prefill_path}")
    for n in sorted({s.prompt_len for s in specs}):  # warm-up
        srv.submit(prompts[0][:1] * n, 2, arrival=0.0)
    srv.drain()
    srv.reset()
    torch.cuda.reset_peak_memory_stats()
    mods = (flash_attention, rmsnorm, paged)
    for mod in mods:
        mod.reset_launches()
    with _DropFracs() as drops:
        for sp in specs:
            srv.submit(prompts[sp.rid], sp.max_new, arrival=sp.arrival, rid=sp.rid)
        streams = srv.drain()
    torch.cuda.synchronize()
    counts = {k: v for mod in mods for k, v in mod.launches.items()}
    met = srv.metrics()
    events = srv.trace_events()
    ticks = [e.dur for e in events if e.name == "decode"]
    slot_forwards = sum(e.args.get("active", 0) for e in events if e.name == "decode")
    pre = [e for e in events if e.name == "prefill"]
    long_pre = sum(srv._prefill_blocks(e.args["tokens"]) * BS > cfg.attn_kv_chunk
                   for e in pre)
    L = cfg.num_layers
    want = {"flash_fwd": L * long_pre, "flash_bwd": 0,
            "rmsnorm_fwd": (3 * L + 1) * (len(pre) + slot_forwards), "rmsnorm_bwd": 0,
            "paged_decode": 0, "paged_prefill": 0}
    log(f"[{tag}] finished={met['finished']}/{len(specs)} tokens={met['generated_tokens']} "
        f"tokens_per_s={met['tokens_per_s']:.2f} ttft_p50_s={met['ttft_p50_s']:.4f} "
        f"ttft_p99_s={met['ttft_p99_s']:.4f} decode_tick_median_ms="
        f"{1e3 * statistics.median(ticks):.3f} ticks={len(ticks)} slot_forwards="
        f"{slot_forwards} prefills={len(pre)} (past attn_kv_chunk {long_pre}) "
        f"prefill_median_ms={1e3 * statistics.median(e.dur for e in pre):.3f} "
        f"preemptions={met['preemptions']} wall_s={met['wall_s']:.3f} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} ({smi})")
    log(f"[{tag}] launches {counts}, expected {want}")
    log(f"[{tag}] moe_drop_frac by path: {drops}")
    if counts != want or not (want["flash_fwd"] and want["rmsnorm_fwd"]):
        raise AssertionError(f"{tag}: launches {counts} != {want}")
    if met["finished"] != len(specs):
        raise AssertionError(f"{tag}: not every request finished")
    for sp in specs:
        toks = streams[sp.rid]
        if len(toks) != sp.max_new or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{tag}: request {sp.rid}: bad stream {toks[:8]}...")
    # the served slots decode over the gathered view of the whole table
    # width: the replays keep that cache length, so the kernel replay runs
    # the served computation
    cache_len = scfg.max_blocks_per_slot * scfg.block_size
    t0 = time.perf_counter()
    teacher_forced(torch, cfg, srv, specs, prompts, streams, tag, pin_routing=True,
                   replay_fn=partial(_dense_replay, cache_len=cache_len),
                   flips_above_noise=True)
    log(f"[{tag}] teacher-forced replays {time.perf_counter() - t0:.1f} s")
    profile_decode_tick(torch, cfg, srv.params, ticks=1, tag=tag, gathered=True)
    del srv
    _free(torch)
    return counts


def _encdec_replay(torch, cfg, params, batch: dict, forced, *, plain: bool):
    """Teacher-forced logits ``[B, n, V]`` of the encoder-decoder over its
    static cache: prefill ``batch`` (frames and prompts), then feed the
    columns ``forced[:, :-1]`` one step at a time at the served cache
    length, through the kernels or (``plain``) the plain versions."""
    from repro_torch.models import encdec

    B, P = batch["tokens"].shape
    n = forced.shape[1]
    cache = encdec.init_cache(cfg, B, P + n, P, device=forced.device)
    with torch.no_grad():
        logits, _ = encdec.prefill(cfg, params, batch, cache, plain=plain)
        out = [logits]
        for i in range(n - 1):
            logits, _ = encdec.decode_step(cfg, params, cache, forced[:, i], P + i,
                                           plain=plain)
            out.append(logits)
    return torch.stack(out, 1).float()


def serve_encdec(torch, smi: str) -> dict:
    """Static serving of seamless-m4t-large-v2 at full width and depth (24
    encoder and 24 decoder layers, seed-0 weights drawn in bf16) through
    the Session, as ``python -m repro_torch serve --arch
    seamless-m4t-large-v2`` runs it (not continuous: JAX serves enc-dec
    statically only): 4 prompts of 2048 tokens over 2048 source frames, 32
    new tokens.  K2 launched exactly once a layer of the prefill's
    encoder (bidirectional, S = T = 2048) and once a decoder layer (the
    cross-attention over the memory); the prefill's cached decoder
    self-attention and every decode step run plain PyTorch, and there is
    no K1, K3 or K4.  Then the served tokens teacher-forced through the
    kernels and through the plain versions on the same weights, prompts
    and frames: logits within ``LOGIT_TOL``, argmax agreements logged (the
    full-depth bf16 random model is noise-dominated, P14, so the streams
    are not compared token for token).  Prefill ms, decode ms a step,
    tokens/s and peak memory logged, and one prefill's and one decode
    step's host and device time.  Returns the launch counts."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.kernels import paged_attention as paged
    from repro_torch.models import encdec

    tag = "serve-encdec"
    dev = torch.device("cuda")
    cfg = get_config("seamless-m4t-large-v2")
    B, P, new = (ENCDEC_SERVE[k] for k in ("batch", "prompt_len", "max_new"))
    argv = ["serve", "--arch", cfg.name, "--batch", str(B), "--prompt-len", str(P),
            "--max-new", str(new), "--seed", "0", "--modules", "scan,metrics"]
    mods = (flash_attention, rmsnorm, paged)
    for m in mods:
        m.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session, (gen, met) = _session(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for m in mods for k, v in m.launches.items()}
    peak = torch.cuda.max_memory_allocated()
    prompts = session.results["static_prompts"]
    del session
    _free(torch)
    want = {"flash_fwd": cfg.num_encoder_layers + cfg.num_layers, "flash_bwd": 0,
            "rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "paged_decode": 0, "paged_prefill": 0}
    log(f"[{tag}] python -m repro_torch {' '.join(argv)}: {cfg.num_encoder_layers} + "
        f"{cfg.num_layers} layers d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} dh={cfg.head_dim} vocab={cfg.padded_vocab}; prefill_ms="
        f"{1e3 * met['prefill_s']:.3f} ({B} x {P} tokens over {B} x {P} frames) "
        f"decode_ms_per_step={1e3 * met['decode_s'] / (new - 1):.3f} decode_tok_s="
        f"{met['decode_tok_s']:.2f} tokens_per_s="
        f"{B * new / (met['prefill_s'] + met['decode_s']):.2f} wall_s={wall:.2f} "
        f"(init included) max_memory_allocated={peak} ({smi})")
    log(f"[{tag}] launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} != {want}")
    if len(gen) != B or any(len(row) != new or not all(0 <= t < cfg.vocab_size for t in row)
                            for row in gen):
        raise AssertionError(f"{tag}: bad outputs {[row[:8] for row in gen]}")
    # the Session's inputs again: its weights (seed 0, bf16 as drawn), its
    # prompts and the frames it drew after them from the same generator
    rng = np.random.default_rng(0)
    if rng.integers(2, cfg.vocab_size, size=(B, P)).tolist() != prompts:
        raise AssertionError(f"{tag}: the prompts are not the run's generator's")
    batch = {"tokens": torch.tensor(prompts, device=dev),
             "embeds": torch.from_numpy(rng.standard_normal((B, P, cfg.d_model)).astype(
                 np.float32)).to(dev, torch.bfloat16)}
    params = encdec.init(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    forced = torch.tensor(gen, device=dev)
    t0 = time.perf_counter()
    rep = {}
    for plain in (False, True):
        flash_attention.reset_launches()
        rep[plain] = _encdec_replay(torch, cfg, params, batch, forced, plain=plain)
        log(f"[{tag}] replay {'plain' if plain else 'kernels'}: K2 launches "
            f"{flash_attention.launches['flash_fwd']}")
    diff = (rep[False] - rep[True]).abs().amax(-1)      # [B, n]
    agree = {k: int((r.argmax(-1) == forced).sum()) for k, r in
             (("kernels", rep[False]), ("plain", rep[True]))}
    both = int((rep[False].argmax(-1) == rep[True].argmax(-1)).sum())
    log(f"[{tag}] teacher-forced, kernels vs plain: max |dlogit| {diff.max().item():.4f} "
        f"(tol {LOGIT_TOL}), per prompt {[round(v, 4) for v in diff.amax(1).tolist()]}; "
        f"argmax equal to the served tokens: kernels {agree['kernels']}, plain "
        f"{agree['plain']}, kernels = plain {both} of {B * new}; "
        f"{time.perf_counter() - t0:.1f} s")
    # where a prefill's and a decode step's time goes: the host clock around
    # one call, its kernels' device time under torch.profiler (each call
    # rewrites the same cache entries)
    cache = encdec.init_cache(cfg, B, P + new, P, device=dev)
    with torch.no_grad():
        calls = {"prefill": lambda: encdec.prefill(cfg, params, batch, cache),
                 "decode step": lambda: encdec.decode_step(cfg, params, cache,
                                                           forced[:, 0], P)}
        for what, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host = 1e3 * (time.perf_counter() - t1)
            split = _kernel_split(torch, fn)
            busy = sum(ms for _, ms in split)
            top = sorted(split, key=lambda kv: -kv[1])[:4]
            log(f"[{tag}] one {what}: host {host:.3f} ms, device busy {busy:.3f} ms in "
                f"{len(split)} kernel names, idle share {1 - busy / host:.3f}; largest: "
                + "; ".join(f"{n[:60]} {ms:.3f}" for n, ms in top))
    del params, rep, batch, cache
    _free(torch)
    if not diff.max().item() <= LOGIT_TOL:
        raise AssertionError(f"{tag}: teacher-forced logits, kernels against plain, "
                             f"differ by {diff.max().item()} > {LOGIT_TOL}")
    return counts


# ---------------------------------------------------------------- phase 6-7


def per_step_launches(cfg, n_micro: int = 1) -> dict:
    """Kernel launches one train step makes with full remat: every layer's
    forward runs twice (once in the forward, once recomputed in the
    backward) and its backward once; two RMSNorms a layer (no qk_norm in
    the trained configs), three under MLA (its latent norm), and the final
    norm, which is not recomputed.  A pipelined step runs every layer once
    for each of its ``n_micro`` microbatches and the final norm once, over
    the whole batch.  The encoder-decoder's layernorms are plain PyTorch;
    its encoder layers run one attention, its decoder layers two (self and
    cross), each on K2 past ``attn_kv_chunk``."""
    from repro_torch.models.lm import segment_layout

    if cfg.family == "encdec":  # K2 in the encoder, the cross and the decoder
        n = (cfg.num_encoder_layers + 2 * cfg.num_layers) * n_micro
        return {"flash_fwd": 2 * n, "flash_bwd": n, "rmsnorm_fwd": 0, "rmsnorm_bwd": 0}
    kinds = [k for pat, n in segment_layout(cfg) for _ in range(n) for k in pat]
    mixer = {"dense": "flash", "moe": "flash", "attn": "flash", "rwkv": "wkv6",
             "rec": "rglru"}
    norms = sum(3 if cfg.use_mla and k in ("dense", "moe") else 2 for k in kinds)
    out = {"rmsnorm_fwd": 2 * norms * n_micro + 1,
           "rmsnorm_bwd": norms * n_micro + 1}
    for kind in kinds:
        for way, n in (("fwd", 2), ("bwd", 1)):
            name = f"{mixer[kind]}_{way}"
            out[name] = out.get(name, 0) + n * n_micro
    return out


def profile_train_step(torch, cfg, ocfg, data, state, tag: str, step_s: float,
                       plan=None, batch: dict | None = None) -> None:
    """One more train step (after the run, outside its launch counts) under
    ``torch.profiler``: the device time of its kernels, summed, and split
    by kernel family (K2 ``flash``, K1 ``rmsnorm``, K5 ``wkv6``, K6
    ``rglru``, cuBLAS's matrix products ``gemm``, the rest); against the
    median unprofiled step ``step_s`` that gives the device's idle share of
    a step.  ``plan`` profiles the pipelined step of that plan; ``batch``
    replaces the ``SyntheticTokens`` batch of ``data``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.train.train_step import make_train_step

    step = make_train_step(cfg, ocfg, plan=plan)
    if batch is None:
        batch = SyntheticTokens(data).batch_at(0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, metrics = step(state, batch)
        float(metrics["loss"])
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"[{tag}] the profiler recorded no device time: the step's split not measured")
        return
    families = {"flash": 0.0, "rmsnorm": 0.0, "wkv6": 0.0, "rglru": 0.0, "gemm": 0.0,
                "other": 0.0}
    others: dict[str, float] = {}
    for e in kernels:
        name = e.name.lower()
        fam = next((f for f in ("flash", "rmsnorm", "wkv6", "rglru") if f in name),
                   "gemm" if any(w in name for w in ("gemm", "matmul", "cutlass", "nvjet",
                                                     "xmma")) else "other")
        families[fam] += e.device_time_total / 1e3
        if fam == "other":
            others[e.name[:70]] = others.get(e.name[:70], 0.0) + e.device_time_total / 1e3
    busy = sum(families.values())
    log(f"[{tag}] one step under torch.profiler: device busy {busy:.1f} ms in "
        f"{len(kernels)} kernels ("
        + ", ".join(f"{f} {ms:.1f}" for f, ms in families.items() if ms)
        + f" ms); median step {1e3 * step_s:.1f} ms; device idle share "
        f"{1 - busy / (1e3 * step_s):.3f}")
    top = sorted(others.items(), key=lambda kv: -kv[1])[:5]
    log(f"[{tag}] largest of the rest: " + "; ".join(f"{n} {ms:.1f} ms" for n, ms in top))


def _steps_on_batch(torch, step, state, batch: dict, data, steps: int,
                    modules: tuple) -> tuple:
    """``steps`` steps of ``step`` on one repeated ``batch``, the launches of
    ``modules`` counted from zero: ``(state, history, counts, peak memory)``,
    history rows as the loop's."""
    torch.cuda.reset_peak_memory_stats()
    for m in modules:
        m.reset_launches()
    history = []
    for i in range(steps):
        t0 = time.perf_counter()
        state, met = step(state, batch)
        loss = float(met["loss"])
        dt = time.perf_counter() - t0
        history.append(dict(step=i + 1, loss=loss, lr=float(met["lr"]),
                            grad_norm=float(met["grad_norm"]), step_s=dt,
                            tokens_per_s=data.seq_len * data.global_batch / dt))
    torch.cuda.synchronize()
    counts = {k: v for m in modules for k, v in m.launches.items()}
    return state, history, counts, torch.cuda.max_memory_allocated()


def _train_setup(cfg, shape: dict):
    """The data and optimizer configs of a train phase: ``shape``'s sequence,
    batch and data seed, the CLI's optimizer defaults (lr 3e-4, cosine,
    warmup max(steps // 10, 5))."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.optim import OptimizerConfig

    steps = shape["steps"]
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=shape["seq_len"],
                      global_batch=shape["global_batch"], seed=shape["seed"])
    ocfg = OptimizerConfig(lr=3e-4, schedule="cosine",
                           warmup_steps=max(steps // 10, 5), total_steps=steps)
    return data, ocfg


def _check_train(tag: str, cfg, data, history: list, counts: dict,
                 passes: int, peak: int, n_micro: int = 1) -> dict:
    """Logs a train run's steps and launches and checks them: each kernel
    of ``counts`` launched exactly :func:`per_step_launches` times (for
    ``n_micro`` pipeline microbatches) for each of ``passes``
    forward-and-backward passes, every loss finite and the last below the
    first.  Returns the run's numbers."""
    steps = len(history)
    for h in history:
        log(f"[{tag}] step {h['step']} loss={h['loss']:.4f} lr={h['lr']:.3e} "
            f"grad_norm={h['grad_norm']:.4f} step_ms={1e3 * h['step_s']:.1f} "
            f"tokens_per_s={h['tokens_per_s']:.1f}")
    want = per_step_launches(cfg, n_micro)
    per_step = {k: want.get(k, 0) for k in counts}
    steady = sorted(h["step_s"] for h in history[1:])
    step_s = steady[len(steady) // 2]
    tokens = data.seq_len * data.global_batch
    log(f"[{tag}] launches per pass {dict((k, v / passes) for k, v in counts.items())} "
        f"expected {per_step} ({passes} forward-and-backward passes)")
    log(f"[{tag}] median step (steps 2-{steps}) {1e3 * step_s:.1f} ms, "
        f"{tokens / step_s:.1f} tokens/s; first step {1e3 * history[0]['step_s']:.1f} ms; "
        f"max_memory_allocated={peak}")
    if any(counts[k] != passes * n for k, n in per_step.items()):
        raise AssertionError(f"{tag} launches {counts} != {passes} x {per_step}")
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag} losses not finite and falling: {losses}")
    return dict(step_s=step_s, tokens_per_s=tokens / step_s, peak=peak,
                losses=losses)


def train_phase(torch, dev, cfg, shape: dict, modules: tuple, tag: str, hooks=None,
                registry=None):
    """``cfg`` (full width) trained ``shape["steps"]`` steps at its sequence
    and batch, on ``SyntheticTokens`` of ``shape["seed"]``, through the
    loop, from the parameters of seed 0, at the CLI's optimizer defaults;
    each kernel of ``modules`` must launch exactly :func:`per_step_launches`
    times a step, and every loss must be finite and the last below the
    first.  ``hooks`` (the loop's ``StepHooks``) observe each step; with a
    ``registry`` the loop publishes its train series there, counting the
    step's flops on the meta device (no launch).
    Returns the config (remat full), the data config, the launch counts and
    the step's numbers."""
    from repro_torch.models.model import count_params
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.train_step import init_train_state

    cfg = cfg.replace(remat="full")
    steps = shape["steps"]
    data, ocfg = _train_setup(cfg, shape)
    state = init_train_state(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = count_params(state.master)
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} vocab={cfg.padded_vocab} "
        f"params={n_params} remat={cfg.remat} "
        f"seq={data.seq_len} batch={data.global_batch} data seed={data.seed}")
    torch.cuda.reset_peak_memory_stats()
    for m in modules:
        m.reset_launches()
    state, history = train(cfg, ocfg, data, LoopConfig(n_steps=steps, seed=0),
                           state=state, device=dev, hooks=hooks, registry=registry)
    torch.cuda.synchronize()
    counts = {k: v for m in modules for k, v in m.launches.items()}
    steady = sorted(h["step_s"] for h in history[1:])
    profile_train_step(torch, cfg, ocfg, data, state, tag, steady[len(steady) // 2])
    del state
    torch.cuda.empty_cache()
    stats = _check_train(tag, cfg, data, history, counts, steps,
                         torch.cuda.max_memory_allocated())
    return cfg, data, counts, dict(stats, params=n_params)


def _patch_grid_batch(torch, cfg, B: int, S: int, seed: int, dev) -> dict:
    """``make_batch``'s embeddings and targets (numpy seed ``seed``) with
    the M-RoPE ids of a patch grid in place of its three equal streams: 16
    text tokens, an image of S/64 x 3S/128 patches (32 x 48 at S = 2048; t
    fixed at the image's start, h and w its rows and columns from there),
    then text from one past the grid's largest id."""
    import numpy as np

    from repro_torch.models.model import make_batch

    batch = make_batch(cfg, B, S, np.random.default_rng(seed), device=dev)
    before, rows, cols = 16, S // 64, 3 * S // 128
    ids = [(p, p, p) for p in range(before)]
    ids += [(before, before + r, before + c) for r in range(rows) for c in range(cols)]
    nxt = before + max(rows, cols)
    ids += [(nxt + p,) * 3 for p in range(S - len(ids))]
    batch["mrope_position_ids"] = (torch.tensor(ids, dtype=torch.int32, device=dev)
                                   .T[:, None].expand(3, B, S).contiguous())
    return batch


def train_configs_phase(torch, dev, smi: str) -> None:
    """Training at the dense configs' and phi3.5-moe's full width (depth cut
    where the train state does not fit), remat full, the CLI's optimizer
    defaults: qwen2-vl-7b at 4 layers through ``make_train_step`` on one
    ``make_batch`` batch (input embeddings, three equal M-RoPE streams; the
    loop refuses an embeds arch, ROADMAP R8), minicpm-2b at full depth
    through ``Session`` (``train --arch minicpm-2b``, which picks the wsd
    schedule), phi3.5-moe at 2 layers through the loop with its aux loss
    and ``seg0_moe_drop_frac`` in every step's metrics.  Each: K2 and K1
    launched exactly :func:`per_step_launches` times a pass, losses finite
    and falling, the profiler's split of one more step, then the step
    check at the qwen2 check's limits (qwen2-vl's on a patch grid's M-RoPE
    ids, phi3.5-moe's plain run pinned to the kernel run's routing)."""
    from dataclasses import replace

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.models.model import count_params, make_batch
    from repro_torch.train.loop import StepHooks
    from repro_torch.train.train_step import init_train_state, make_train_step

    mods = (flash_attention, rmsnorm)
    tols = (STEP_LOSS_TOL, STEP_GNORM_RTOL, STEP_LEAF_RTOL)

    # qwen2-vl-7b: the train state of all 28 layers (~122 GB) does not fit
    tag = "train-qwen2-vl"
    full = get_config("qwen2-vl-7b")
    cfg = full.replace(num_layers=QWEN2VL_LAYERS, remat="full")
    data, ocfg = _train_setup(cfg, QWEN2VL_TRAIN)
    state = init_train_state(cfg, seed=0, device=dev)
    batch = make_batch(cfg, data.global_batch, data.seq_len,
                       np.random.default_rng(QWEN2VL_TRAIN["seed"]), device=dev)
    step = make_train_step(cfg, ocfg)
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} of {full.num_layers} layers d_model="
        f"{cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} mrope "
        f"{cfg.mrope_sections} params={count_params(state.master)} remat={cfg.remat} "
        f"seq={data.seq_len} batch={data.global_batch}: make_train_step on one "
        f"make_batch batch ({', '.join(f'{k} {tuple(v.shape)}' for k, v in batch.items())})")
    state, history, counts, peak = _steps_on_batch(
        torch, step, state, batch, data, QWEN2VL_TRAIN["steps"], mods)
    steady = sorted(h["step_s"] for h in history[1:])
    profile_train_step(torch, cfg, ocfg, data, state, tag, steady[len(steady) // 2],
                       batch=batch)
    del state, step, batch
    torch.cuda.empty_cache()
    _check_train(tag, cfg, data, history, counts, QWEN2VL_TRAIN["steps"], peak)
    step_check(torch, dev, cfg, data, mixer="attn", tag="step-qwen2-vl", batch_step=0,
               tols=tols, batch=_patch_grid_batch(torch, cfg, data.global_batch,
                                                 data.seq_len, 1, dev))

    # minicpm-2b at full depth through the Session, as the CLI runs it
    tag = "train-minicpm"
    argv = ["train", "--arch", "minicpm-2b", "--seq-len", str(MINICPM_TRAIN["seq_len"]),
            "--global-batch", str(MINICPM_TRAIN["global_batch"]),
            "--steps", str(MINICPM_TRAIN["steps"])]
    session, state, history, counts, peak = _counted_session(torch, argv, mods)
    cfg = session.model_cfg
    schedule = session._train_derived()[2]
    data, ocfg = _train_setup(cfg, MINICPM_TRAIN)
    ocfg = replace(ocfg, schedule=schedule)
    passes = MINICPM_TRAIN["steps"]
    log(f"[{tag}] python -m repro_torch {' '.join(argv)}: {cfg.num_layers} layers "
        f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} vocab="
        f"{cfg.padded_vocab} params={count_params(state.master)} schedule={schedule} "
        f"modules={','.join(session.run_cfg.modules)}")
    if schedule != "wsd":
        raise AssertionError(f"{tag}: the Session picked {schedule}, not wsd")
    steady = sorted(h["step_s"] for h in history[1:])
    profile_train_step(torch, cfg, ocfg, data, state, tag, steady[len(steady) // 2])
    del state, session
    torch.cuda.empty_cache()
    _check_train(tag, cfg, data, history, counts, passes, peak)
    step_check(torch, dev, cfg.replace(remat="full"), data, mixer="attn",
               tag="step-minicpm", batch_step=MINICPM_TRAIN["steps"], tols=tols)

    # phi3.5-moe: 2 of 32 layers (the train state of all 32 is ~670 GB)
    tag = "train-moe"
    rows = []

    def on_step(events, metrics):
        rows.append({k: float(metrics[k]) for k in ("aux_loss", "seg0_moe_drop_frac")})

    full = get_config("phi3.5-moe-42b-a6.6b")
    cfg = full.replace(num_layers=PHI_TRAIN_LAYERS)
    log(f"[{tag}] depth cut: {PHI_TRAIN_LAYERS} of {full.num_layers} layers, full width "
        f"({cfg.moe.num_experts} experts of {cfg.moe.expert_d_ff}, top-{cfg.moe.top_k})")
    cfg, data, counts, stats = train_phase(torch, dev, cfg, PHI_TRAIN, mods, tag,
                                           hooks=StepHooks(on_step=on_step))
    log(f"[{tag}] params {stats['params']}; per step " + "; ".join(
        f"aux_loss={r['aux_loss']:.6f} seg0_moe_drop_frac={r['seg0_moe_drop_frac']:.4f}"
        for r in rows))
    if len(rows) != PHI_TRAIN["steps"] or not all(
            r["aux_loss"] > 0 and math.isfinite(r["aux_loss"])
            and 0 <= r["seg0_moe_drop_frac"] < 1 for r in rows):
        raise AssertionError(f"{tag}: aux_loss and seg0_moe_drop_frac not in the metrics "
                             f"of every step: {rows}")
    step_check(torch, dev, cfg, data, mixer="attn", tag="step-moe",
               batch_step=PHI_TRAIN["steps"], tols=tols, pin_routing=True)
    torch.cuda.empty_cache()


def train_mla_phase(torch, dev, smi: str) -> dict:
    """deepseek-v2-lite-16b at full width cut to ``MLA_TRAIN_LAYERS`` of 27
    layers (1 dense, 3 MoE) trained through the loop, remat full, seq 2048
    x batch 2, 4 steps, on ``SyntheticTokens`` of seed 2 (seed 0's rule
    shares the factors 2 and 5 of vocab 102400, as at Griffin's 256000: its
    targets run into a fixed point, and its losses swing): the train state
    estimated before the run, the parameter count, K2 (q/k at 192, v at
    128) and K1 (three norms a layer) launched exactly
    :func:`per_step_launches` times a step (the flop count, on the meta
    device, launches none),
    losses finite and falling, the profiler's split
    of one more step, peak memory and ``mfu_est`` (the p50 of the loop's
    ``train.model_flops_per_s`` over the H100's 989 TFLOP/s, as the
    ``metrics`` module reports it; K2's products counted at each side's
    width); then the step check at the qwen2 check's limits, the plain run
    routed as the kernel run routed (the flips held to ``MOE_FLIP_SHARE``
    above the noise probe's).  Returns the launch counts of the run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.obs import MetricsRegistry

    tag = "train-mla"
    full = get_config("deepseek-v2-lite-16b")
    cfg = full.replace(num_layers=MLA_TRAIN_LAYERS)
    log(f"[{tag}] depth cut: {MLA_TRAIN_LAYERS} of {full.num_layers} layers, full width; "
        f"train state estimated {MLA_TRAIN_PARAMS} x 18 B = "
        f"{MLA_TRAIN_PARAMS * 18 / 1e9:.1f} GB (float32 master, AdamW m and v, bf16 "
        f"params and grads)")
    registry = MetricsRegistry()
    cfg, data, counts, stats = train_phase(torch, dev, cfg, MLA_TRAIN,
                                           (flash_attention, rmsnorm), tag,
                                           registry=registry)
    if stats["params"] != MLA_TRAIN_PARAMS:
        raise AssertionError(f"{tag}: {stats['params']} parameters, not {MLA_TRAIN_PARAMS}")
    flops_s = registry.snapshot()["train.model_flops_per_s"]
    mfu = flops_s["p50"] / BF16_FLOPS_PER_S
    log(f"[{tag}] params {stats['params']}; model flops a step "
        f"{flops_s['p50'] * stats['step_s']:.6e}; mfu_est {mfu:.6f} at a peak of "
        f"{BF16_FLOPS_PER_S / 1e12:g} TFLOP/s ({smi})")
    if not 0 < mfu < 1:
        raise AssertionError(f"{tag}: mfu_est {mfu} not in (0, 1)")
    step_check(torch, dev, cfg, data, mixer="attn", tag="step-mla",
               batch_step=MLA_TRAIN["steps"],
               tols=(STEP_LOSS_TOL, STEP_GNORM_RTOL, STEP_LEAF_RTOL), pin_routing=True,
               flips_above_noise=True)
    torch.cuda.empty_cache()
    return counts


def train_encdec_phase(torch, dev, smi: str) -> dict:
    """seamless-m4t-large-v2 trained at full width and depth (24 + 24
    layers), remat full, through ``make_train_step`` on one repeated
    ``make_batch`` batch of numpy seed 0 (2048 source frames and 2048
    target tokens a row, 4 rows; the loop refuses an embeds arch, ROADMAP
    R8), the CLI's optimizer defaults, 4 steps: the train state estimated
    before the init, the parameter count, K2 launched exactly
    :func:`per_step_launches` times a step (144 forwards and 72 backwards:
    48 / 24 each in the encoder, the cross-attention and the decoder),
    losses finite and falling, the profiler's split of one more step, peak
    memory and ``mfu_est`` (the step's products, ``step_flops``, over the
    median step and the H100's 989 TFLOP/s; counted on the meta device,
    and held equal to a real pass's count on the card); the dryrun's cell
    of the same step (meta device) estimated first, its ``peak_est_bytes``
    held within ``PEAK_RTOL`` of the steps' peak above what was allocated
    before the state; then the step check at the qwen2 check's limits, the
    decoder's cross-attention leaves beside the attention's.  Returns the
    launch counts of the run."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.launch.dryrun import estimate
    from repro_torch.launch.specs import input_specs
    from repro_torch.models.model import count_params, make_batch
    from repro_torch.train.loop import step_flops
    from repro_torch.train.train_step import init_train_state, make_train_step

    tag = "train-encdec"
    mods = (flash_attention, rmsnorm)
    cfg = get_config("seamless-m4t-large-v2").replace(remat="full")
    steps = ENCDEC_TRAIN["steps"]
    log(f"[{tag}] {cfg.name} at full depth ({cfg.num_encoder_layers} + {cfg.num_layers} "
        f"layers): train state estimated {ENCDEC_PARAMS} x 18 B = "
        f"{ENCDEC_PARAMS * 18 / 1e9:.1f} GB (float32 master, AdamW m and v, bf16 "
        f"params and grads)")
    data, ocfg = _train_setup(cfg, ENCDEC_TRAIN)
    est = estimate(input_specs(cfg, ShapeConfig("train_2048x4", data.seq_len,
                                                data.global_batch, "train"), ocfg=ocfg))
    _free(torch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = init_train_state(cfg, seed=0, device=dev)
    n_params = count_params(state.master)
    if n_params != ENCDEC_PARAMS:
        raise AssertionError(f"{tag}: {n_params} parameters, not {ENCDEC_PARAMS}")
    batch = make_batch(cfg, data.global_batch, data.seq_len,
                       np.random.default_rng(ENCDEC_TRAIN["seed"]), device=dev)
    log(f"[{tag}] params={n_params} remat={cfg.remat} d_model={cfg.d_model} heads="
        f"{cfg.num_heads}/{cfg.num_kv_heads} dh={cfg.head_dim} d_ff={cfg.d_ff} vocab="
        f"{cfg.padded_vocab}: make_train_step on one make_batch batch ("
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items()) + ")")
    step = make_train_step(cfg, ocfg)
    state, history, counts, peak = _steps_on_batch(torch, step, state, batch, data,
                                                   steps, mods)
    dryrun_peak(torch, dev, cfg, ENCDEC_TRAIN, tag, smi, base=base, peak=peak, est=est)
    steady = sorted(h["step_s"] for h in history[1:])
    step_s = steady[len(steady) // 2]
    profile_train_step(torch, cfg, ocfg, data, state, tag, step_s, batch=batch)
    flops = step_flops(cfg, state, batch)
    real = step_flops(cfg, state, batch, meta=False)
    log(f"[{tag}] flops a step: the cell's {est['flops']}, the meta count {int(flops)}, "
        f"a real pass on the card {int(real)}")
    if not est["flops"] == flops == real > 0:
        raise AssertionError(f"{tag}: flop counts differ: {est['flops']}, {flops}, {real}")
    mfu = flops / step_s / BF16_FLOPS_PER_S
    del state, step
    torch.cuda.empty_cache()
    _check_train(tag, cfg, data, history, counts, steps, peak)
    log(f"[{tag}] model flops a step {flops:.6e}; mfu_est {mfu:.6f} at a peak of "
        f"{BF16_FLOPS_PER_S / 1e12:g} TFLOP/s ({smi})")
    if not 0 < mfu < 1:
        raise AssertionError(f"{tag}: mfu_est {mfu} not in (0, 1)")
    step_check(torch, dev, cfg, data, mixer=("attn", "cross"), tag="step-encdec",
               batch_step=0, tols=(STEP_LOSS_TOL, STEP_GNORM_RTOL, STEP_LEAF_RTOL),
               batch=batch)
    del batch
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------- phase 6: the runtime path

RUNTIME_DIR = REPO / "build" / "chip_smoke_runtime"
# the runtime phase's checkpoint run: qwen2-0.5b at full width cut to 2 of
# its 24 layers (2.3 GB of train state a checkpoint, where the full
# model's ~6.9 GB would take three times the disk and time)
RUNTIME_LAYERS = 2
CKPT_EVERY = 4


def _session(argv: list[str], model_cfg=None):
    """A ``Session`` built from command-line arguments as ``python -m
    repro_torch`` builds it, and what its workload returns."""
    from repro_torch.app.cli import parse
    from repro_torch.app.session import Session

    _, rc = parse(argv)
    session = Session(rc, model_cfg=model_cfg)
    return session, session.run()


class _GcPauses:
    """Python's full (generation 2) garbage collections while it is
    entered: how many, and their longest and total pause, host clock.  It
    collects first, so a pause inside is owed to what the run itself
    allocates, not to the earlier phases' garbage (a profiler's event
    lists are cyclic, and only a full collection frees them)."""

    def __enter__(self):
        import gc

        gc.collect()
        self.pauses, self._t0 = [], 0.0
        gc.callbacks.append(self._on_gc)
        return self

    def _on_gc(self, phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.pauses.append(time.perf_counter() - self._t0)

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._on_gc)

    def __str__(self):
        p = self.pauses
        return (f"{len(p)} full gc pauses, longest {1e3 * max(p, default=0):.1f} ms, "
                f"total {1e3 * sum(p):.1f} ms")


def _train_argv(shape: dict) -> list[str]:
    return ["train", "--arch", "qwen2-0.5b", "--seq-len", str(shape["seq_len"]),
            "--global-batch", str(shape["global_batch"]),
            "--steps", str(shape["steps"]), "--seed", str(shape["seed"])]


def _spans(events) -> dict:
    out: dict = {}
    for e in events:
        if e.kind != "counter":
            out[e.name] = out.get(e.name, 0) + 1
    return out


def train_session_phase(torch, dev, modules: tuple, smi: str, tag: str = "train"):
    """Full-width qwen2-0.5b trained through ``Session`` as ``python -m
    repro_torch train`` runs it, with ``--modules scan,metrics``, a chrome
    trace, a metrics file and ``obs.peak_tflops=989`` (the H100 SXM's dense
    bf16 peak): the launch counts (a forward and backward a step: the flop
    count runs on the meta device), finite and falling losses and the
    profiler split as
    :func:`train_phase` checks them; then the trace (``init``, a
    ``train_step`` a step, counter events; its ``.jsonl`` sidecar the same
    spans), the metrics file (a row a step, ``train.loss`` equal to the
    history's) and ``mfu_est`` in (0, 1).  The same run with ``--modules
    none`` after it (exact launches a step), then the pair again in the
    other order; logs the median steps of each side."""
    from repro_torch.core.tracing import from_chrome, load_jsonl

    out_dir = RUNTIME_DIR / "trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    steps = TRAIN["steps"]
    on_argv = [*_train_argv(TRAIN), "--modules", "scan,metrics",
               "--trace-out", str(out_dir / "train.json"),
               "--metrics-out", str(out_dir / "train_metrics.jsonl"),
               "--set", f"obs.peak_tflops={BF16_FLOPS_PER_S / 1e12:g}"]
    log(f"[{tag}] python -m repro_torch {' '.join(on_argv)}")
    torch.cuda.reset_peak_memory_stats()
    for m in modules:
        m.reset_launches()
    with _GcPauses() as gc_on:
        session, (state, history) = _session(on_argv)
    torch.cuda.synchronize()
    counts = {k: v for m in modules for k, v in m.launches.items()}
    cfg = session.model_cfg
    data, ocfg = _train_setup(cfg, TRAIN)
    steady = sorted(h["step_s"] for h in history[1:])
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model} "
        f"remat={cfg.remat} seq={data.seq_len} batch={data.global_batch}")
    profile_train_step(torch, cfg, ocfg, data, state, tag, steady[len(steady) // 2])
    del state
    torch.cuda.empty_cache()
    stats = _check_train(tag, cfg, data, history, counts, steps,
                         torch.cuda.max_memory_allocated())

    spans = _spans(from_chrome(json.loads((out_dir / "train.json").read_text())))
    n_counters = sum(e.kind == "counter" for e in session.tracer.events)
    sidecar = _spans(load_jsonl(out_dir / "train.jsonl"))
    rows = [json.loads(ln) for ln in
            (out_dir / "train_metrics.jsonl").read_text().splitlines()]
    report = session.results["metrics"]
    mfu = report.get("mfu_est", float("nan"))
    # each row holds the running sums: flops = (flops/step_s) * step_s
    flops = rows[0]["train.model_flops_per_s.sum"] * rows[0]["train.step_time_s.sum"]
    log(f"[{tag}] trace spans {spans} (+{n_counters} counter events), sidecar "
        f"{sidecar}; metrics rows {len(rows)}; flops counted per step "
        f"{flops:.6e}; mfu_est {mfu} at a peak of {BF16_FLOPS_PER_S / 1e12:g} "
        f"TFLOP/s ({smi})")
    if spans != {"init": 1, "train_step": steps} or sidecar != spans or not n_counters:
        raise AssertionError(f"{tag}: trace spans {spans}, sidecar {sidecar}")
    if [r["train.loss"] for r in rows] != stats["losses"]:
        raise AssertionError(f"{tag}: the metrics file's losses differ from the history's")
    if not 0 < mfu < 1:
        raise AssertionError(f"{tag}: mfu_est {mfu} not in (0, 1)")

    for m in modules:
        m.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with _GcPauses() as gc_off:
        _, (state, history_off) = _session([*_train_argv(TRAIN), "--modules", "none"])
    torch.cuda.synchronize()
    del state
    torch.cuda.empty_cache()
    off_counts = {k: v for m in modules for k, v in m.launches.items()}
    off = _check_train(f"{tag}-modules-none", cfg, data, history_off, off_counts,
                       steps, torch.cuda.max_memory_allocated())
    log(f"[{tag}] median step with --modules scan,metrics {1e3 * stats['step_s']:.1f} "
        f"ms, with --modules none {1e3 * off['step_s']:.1f} ms; steps on "
        + ", ".join(f"{1e3 * h['step_s']:.1f}" for h in history[1:]) + "; off "
        + ", ".join(f"{1e3 * h['step_s']:.1f}" for h in history_off[1:]) + f" ({smi})")
    log(f"[{tag}] Python during the runs: modules on {gc_on}; modules none {gc_off}")
    # the pair again in the other order (on, none, none, on), so neither
    # side always runs first: steps 2-8 of both runs of a side pooled
    _, (state, history_off2) = _session([*_train_argv(TRAIN), "--modules", "none"])
    del state
    _, (state, history_on2) = _session(on_argv)
    del state
    torch.cuda.empty_cache()
    ms = lambda *hs: [1e3 * h["step_s"] for hist in hs for h in hist[1:]]  # noqa: E731
    on_ms, off_ms = ms(history, history_on2), ms(history_off, history_off2)
    log(f"[{tag}] steps 2-{steps} in turns on, none, none, on: median with --modules "
        f"scan,metrics {statistics.median(on_ms):.1f} ms (runs "
        f"{statistics.median(ms(history)):.1f}, {statistics.median(ms(history_on2)):.1f}; "
        f"{min(on_ms):.1f}-{max(on_ms):.1f}), with --modules none "
        f"{statistics.median(off_ms):.1f} ms (runs {statistics.median(ms(history_off)):.1f}, "
        f"{statistics.median(ms(history_off2)):.1f}; {min(off_ms):.1f}-{max(off_ms):.1f}) "
        f"({smi})")
    return cfg, data, counts, dict(stats, flops=flops, mfu=mfu)


def runtime_phase(torch, dev, smi: str, tag: str = "runtime") -> None:
    """Async checkpoints and resume on the card: qwen2-0.5b at full width
    cut to :data:`RUNTIME_LAYERS` layers trained 8 steps through ``Session``
    with ``--ckpt-dir`` and ``--ckpt-every 4``; a fresh ``Session`` resumed
    from a directory holding only that run's step-4 checkpoint runs steps
    5-8.  Its losses must equal the uninterrupted run's, every leaf of the
    two step-8 checkpoints must be equal, and the state restored from the
    step-8 checkpoint onto the card must equal the run's final state
    (``torch.equal``).  Then times one ``save_async`` of that state: the
    synchronous stall (the copy to the host) and the background write."""
    import os
    import shutil

    import numpy as np

    from repro_torch.checkpoint import Checkpointer, restore
    from repro_torch.configs import get_config
    from repro_torch.train.optim import leaves

    cfg = get_config("qwen2-0.5b").replace(num_layers=RUNTIME_LAYERS)
    root = RUNTIME_DIR / "ckpt"
    shutil.rmtree(root, ignore_errors=True)
    argv = lambda d: [*_train_argv(TRAIN), "--modules", "none",  # noqa: E731
                      "--ckpt-dir", str(d), "--ckpt-every", str(CKPT_EVERY)]
    log(f"[{tag}] depth cut: {RUNTIME_LAYERS} of {get_config('qwen2-0.5b').num_layers} "
        f"layers, full width; python -m repro_torch {' '.join(argv(root / 'a'))}")
    _, (state, hist) = _session(argv(root / "a"), model_cfg=cfg)
    step4 = f"step_{CKPT_EVERY:08d}"
    # the resumed run's directory holds the step-4 checkpoint alone (hard
    # links: the files are only read)
    shutil.copytree(root / "a" / step4, root / "b" / step4, copy_function=os.link)
    _, (resumed, hist_res) = _session(argv(root / "b"), model_cfg=cfg)
    torch.cuda.synchronize()
    want = [h["loss"] for h in hist[CKPT_EVERY:]]
    got = [h["loss"] for h in hist_res]
    log(f"[{tag}] uninterrupted losses {[h['loss'] for h in hist]}; resumed at step "
        f"{CKPT_EVERY}: steps {[h['step'] for h in hist_res]} losses {got}")
    if [h["step"] for h in hist_res] != list(range(CKPT_EVERY + 1, TRAIN["steps"] + 1)) or got != want:
        raise AssertionError(f"{tag}: resumed losses {got} != uninterrupted {want}")
    for (path, a), (_, b) in zip(leaves(state.master), leaves(resumed.master)):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: resumed master {path} differs")
    del resumed
    final = f"step_{TRAIN['steps']:08d}"
    files = sorted(p.name for p in (root / "a" / final).iterdir())
    if files != sorted(p.name for p in (root / "b" / final).iterdir()):
        raise AssertionError(f"{tag}: the two step-8 checkpoints hold different leaves")
    nbytes = 0
    for name in files:
        a, b = root / "a" / final / name, root / "b" / final / name
        if name.endswith(".npy"):
            nbytes += a.stat().st_size
            if not np.array_equal(np.load(a, mmap_mode="r"), np.load(b, mmap_mode="r")):
                raise AssertionError(f"{tag}: step-8 leaf {name} differs")
    shutil.rmtree(root / "b")
    back, _ = restore(root / "a", state)
    torch.cuda.synchronize()
    for key in ("params", "master"):
        for (path, a), (_, b) in zip(leaves(getattr(back, key)), leaves(getattr(state, key))):
            if a.device != b.device or not torch.equal(a, b):
                raise AssertionError(f"{tag}: restored {key} {path} differs")
    for key in ("m", "v"):
        for (path, a), (_, b) in zip(leaves(back.opt[key]), leaves(state.opt[key])):
            if not torch.equal(a, b):
                raise AssertionError(f"{tag}: restored opt.{key} {path} differs")
    if back.opt["step"] != state.opt["step"]:
        raise AssertionError(f"{tag}: restored step {back.opt['step']}")
    del back
    log(f"[{tag}] resumed losses equal, step-8 checkpoints equal leaf by leaf "
        f"({len(files) - 1} leaves, {nbytes} bytes), restored state equal on the card")
    ck = Checkpointer(root / "timed")
    t0 = time.perf_counter()
    ck.save_async(state, TRAIN["steps"])
    t1 = time.perf_counter()
    ck.wait()
    t2 = time.perf_counter()
    log(f"[{tag}] save_async of {nbytes} bytes: synchronous stall {1e3 * (t1 - t0):.1f} ms "
        f"({nbytes / (t1 - t0) / 1e9:.2f} GB/s to the host), background write "
        f"{t2 - t1:.2f} s ({smi})")
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------- MegaFT

# the ft phase: qwen2-0.5b at full width cut to RUNTIME_LAYERS layers (each
# checkpoint ~2.3 GB), at the train shape, 14 steps, as the JAX package's
# TestChaosAcceptance runs; the world jobs 10 steps, on the pipeline
# phase's world of 2 ranks
FT = dict(seq_len=2048, global_batch=8, steps=14, seed=0)
FT_SKIP_STEPS = 6
FT_WORLD = dict(seq_len=2048, global_batch=8, steps=10, seed=0)
FT_DETECT = ["--detect-online", "--set", "scan.detect_every=4"]
FT_PIPE = ["--pp", "2", "--n-micro", "2", "--set", "parallel.n_chunks=1",
           "--pp-schedule", "1f1b"]
FT_SLOW_STAGE = ["--set", "obs.rank_events=true", "--set", "obs.slow_rank=1",
                 "--set", "obs.slow_factor=0.5", "--set", "ft.slow_frac_hard=1.1"]


def _ft_cfg():
    from repro_torch.configs import get_config

    return get_config("qwen2-0.5b").replace(num_layers=RUNTIME_LAYERS)


def _ft_steps_run(n_steps: int, report: dict | None, spans: int) -> int:
    """The train steps a supervised run actually ran, two ways that must
    agree: from its mitigation timeline (the ``n_steps`` kept, plus the
    steps replayed after each restart, a failed step counted where it ran:
    a guard's, and a skipped one) and from its ``train_step`` spans (a
    skipped step's span is dropped with its events)."""
    ran = n_steps
    for t in (report or {}).get("timeline", []):
        d = t.get("details", {})
        if t["event"] == "restart":      # raised at the step's top
            ran += t["step"] - d["resumed_step"]
        elif t["event"] == "rollback":   # the failing step ran
            ran += t["step"] - d["to_step"] + 1
        elif t["event"] == "guard:skip":
            ran += 1
    skipped = sum(t["event"] == "guard:skip" for t in (report or {}).get("timeline", []))
    if spans + skipped != ran:
        raise AssertionError(f"steps run: {spans} spans + {skipped} skipped, "
                             f"timeline says {ran}")
    return ran


class _FtTimers:
    """While entered, the train loop's checkpoint costs on the host clock:
    each ``save_async``'s synchronous stall (the copy to the host) and each
    ``restore`` (every leaf read back onto the card)."""

    def __enter__(self):
        from repro_torch.checkpoint import checkpointer
        from repro_torch.train import loop

        self.stalls, self.restores = [], []
        real_save, real_restore = checkpointer.Checkpointer.save_async, loop.restore

        def save_async(ck, *a, **kw):
            t0 = time.perf_counter()
            real_save(ck, *a, **kw)
            self.stalls.append(time.perf_counter() - t0)

        def restore(*a, **kw):
            t0 = time.perf_counter()
            out = real_restore(*a, **kw)
            import torch

            torch.cuda.synchronize()
            self.restores.append(time.perf_counter() - t0)
            return out

        self._undo = [(checkpointer.Checkpointer, "save_async", real_save),
                      (loop, "restore", real_restore)]
        checkpointer.Checkpointer.save_async = save_async
        loop.restore = restore
        return self

    def __exit__(self, *exc):
        for obj, name, old in self._undo:
            setattr(obj, name, old)

    def __str__(self):
        ms = lambda xs: ", ".join(f"{1e3 * x:.1f}" for x in xs) or "none"  # noqa: E731
        return f"save_async stalls {ms(self.stalls)} ms; restores {ms(self.restores)} ms"


def _ft_session(torch, argv: list[str], cfg, tag: str):
    """One supervised run through ``Session`` (one process), K1 and K2
    counted from 0, checkpoint costs timed: ``(session, state, history,
    counts, spans, timers)``; logs its timeline."""
    from repro_torch.kernels import flash_attention, rmsnorm

    log(f"[{tag}] python -m repro_torch {' '.join(argv)}")
    with _FtTimers() as timers:
        session, state, history, counts, _ = _counted_session(
            torch, argv, (flash_attention, rmsnorm), model_cfg=cfg)
    spans = sum(e.name == "train_step" for e in session.tracer.events)
    rep = session.results.get("ft")
    if rep is not None:
        log(f"[{tag}] timeline {json.dumps(rep['timeline'])}; restarts {rep['restarts']} "
            f"rollbacks {rep['rollbacks']} replans {rep['replans']} guard_trips "
            f"{rep['guard_trips']} detections {rep['detections']} excluded "
            f"{rep['excluded_ranks']} compression_on {rep['compression_on']}")
    log(f"[{tag}] {timers}")
    return session, state, history, counts, spans, timers


def _ft_launches(tag: str, cfg, counts: dict, passes: int) -> None:
    want = {k: passes * v for k, v in per_step_launches(cfg).items()
            if k.split("_")[0] in ("flash", "rmsnorm")}
    log(f"[{tag}] launches {counts}, expected {want} ({passes} forward-and-backward "
        "passes)")
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} != {want}")


def _ft_medians(history: list[dict], split: int | None = None) -> str:
    """Median steps (host clock), the first step left out, and split at the
    1-based step ``split`` when given."""
    ms = lambda hs: statistics.median(1e3 * h["step_s"] for h in hs)  # noqa: E731
    if split is None:
        return f"median step {ms(history[1:]):.1f} ms"
    before = [h for h in history[1:] if h["step"] < split]
    after = [h for h in history if h["step"] >= split]
    return (f"median step without compression (steps 2-{split - 1}) {ms(before):.1f} ms, "
            f"with it (steps {split}-{history[-1]['step']}) {ms(after):.1f} ms")


def ft_phase(torch, dev, smi: str, tag: str = "ft") -> dict:
    """MegaFT through ``python -m repro_torch train --modules
    scan,metrics,ft`` on the card, one process: qwen2-0.5b at full width cut
    to :data:`RUNTIME_LAYERS` layers, at :data:`FT`.  (a) The fault-free run
    (``--modules none``).  (b) The chaos run of JAX's TestChaosAcceptance
    (``--detect-online``, a checkpoint every 3 steps, a crash at step 5, rank
    1 at half speed from step 0): all 14 steps, every loss equal to the
    fault-free run's (bit for bit, as the runtime phase's resume), at least
    two restarts (the crash, the exclusion), ``decide:exclude`` and
    ``mitigate:exclude`` in the timeline, rank 1 excluded, the first
    detection before step 8.  (c) A degraded link 0-1: compression on once,
    its wire bytes below the baseline, losses finite; the step medians
    without and with it, and the compressor's ms a step (CUDA events).  (d)
    A NaN batch at step 4 rolled back: every loss equal to the fault-free
    run's.  (e) The same NaN skipped: one guard trip, no restart, the last
    loss finite.  K1 and K2 launch exactly as counted for the steps each run
    ran (:func:`_ft_steps_run`; the flop count launches none).  Returns
    the fault-free losses."""
    import shutil

    from repro_torch.ft import GradCompressor
    from repro_torch.train.optim import leaves

    cfg = _ft_cfg()
    root = RUNTIME_DIR / "ft"
    shutil.rmtree(root, ignore_errors=True)
    steps = FT["steps"]
    base = _train_argv(FT)
    log(f"[{tag}] depth cut: {RUNTIME_LAYERS} of 24 layers, full width, seq "
        f"{FT['seq_len']} x batch {FT['global_batch']}, {steps} steps")

    # (a) fault-free
    _, state, clean, counts, _, _ = _ft_session(
        torch, [*base, "--modules", "none"], cfg, f"{tag}-clean")
    del state
    _ft_launches(f"{tag}-clean", cfg, counts, steps)
    ref = [h["loss"] for h in clean]
    log(f"[{tag}-clean] losses {ref}; {_ft_medians(clean)} ({smi})")

    # (b) the chaos run
    argv = [*base, "--modules", "scan,metrics,ft", *FT_DETECT,
            "--ckpt-dir", str(root / "chaos"), "--ckpt-every", "3",
            "--set", "ft.chaos.crash_at_step=5", "--set", "ft.chaos.slow_rank_from=0",
            "--set", "ft.chaos.slow_rank=1", "--set", "ft.chaos.slow_factor=0.5"]
    session, state, hist, counts, spans, timers = _ft_session(
        torch, argv, cfg, f"{tag}-chaos")
    del state
    rep = session.results["ft"]
    online = session.results["scan"]["online"]
    ran = _ft_steps_run(steps, rep, spans)
    _ft_launches(f"{tag}-chaos", cfg, counts, ran)
    events = [t["event"] for t in rep["timeline"]]
    losses = [h["loss"] for h in hist]
    log(f"[{tag}-chaos] steps run {ran}; online {online}; losses {losses}; "
        f"{_ft_medians(hist)} (rank 1 at half speed until excluded) ({smi})")
    if [h["step"] for h in hist] != list(range(1, steps + 1)) or losses != ref:
        raise AssertionError(f"{tag}-chaos: losses {losses} != fault-free {ref}")
    if (rep["restarts"] < 2 or rep["excluded_ranks"] != [1]
            or any(e not in events for e in ("restart", "decide:exclude",
                                             "mitigate:exclude"))
            or not online["first_detect_step"] or online["first_detect_step"] > 8):
        raise AssertionError(f"{tag}-chaos: report {rep}, online {online}")
    if session.results["metrics"]["series"]["ft.restarts"] != rep["restarts"]:
        raise AssertionError(f"{tag}-chaos: the ft.restarts counter")
    stall_ms = statistics.median(timers.stalls) * 1e3
    restore_ms = statistics.median(timers.restores) * 1e3

    # (c) a degraded data link: int8 gradient sync with error feedback
    argv = [*base, "--modules", "scan,metrics,ft", *FT_DETECT,
            "--set", "ft.chaos.degrade_link=0-1"]
    session, state, hist, counts, spans, _ = _ft_session(torch, argv, cfg, f"{tag}-link")
    rep = session.results["ft"]
    _ft_launches(f"{tag}-link", cfg, counts, _ft_steps_run(steps, rep, spans))
    on = [t for t in rep["timeline"] if t["event"] == "mitigate:compress_on"]
    losses = [h["loss"] for h in hist]
    if (len(on) != 1 or not rep["compression_on"]
            or not 0 < on[0]["details"]["wire_bytes_per_sync"]
            < on[0]["details"]["baseline_bytes_per_sync"]
            or not all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"{tag}-link: report {rep}, losses {losses}")
    comp = GradCompressor()
    err = comp.init(state.master)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    comp.apply(state.params, err)  # warm
    ev[0].record()
    for _ in range(5):
        comp.apply(state.params, err)
    ev[1].record()
    torch.cuda.synchronize()
    comp_ms = ev[0].elapsed_time(ev[1]) / 5
    n = sum(t.numel() for _, t in leaves(state.params))
    del state, err
    _free(torch)
    log(f"[{tag}-link] compression on at step {on[0]['step']} (details "
        f"{on[0]['details']}); losses {losses}; {_ft_medians(hist, on[0]['step'] + 1)}; "
        f"GradCompressor.apply on the {n} bf16 gradients {comp_ms:.3f} ms (CUDA events) "
        f"({smi})")

    # (d) a NaN batch, rolled back
    argv = [*base, "--modules", "scan,metrics,ft", "--ckpt-dir", str(root / "nan"),
            "--ckpt-every", "3", "--set", "ft.chaos.nan_at_step=4"]
    session, state, hist, counts, spans, _ = _ft_session(torch, argv, cfg, f"{tag}-nan")
    del state
    rep = session.results["ft"]
    _ft_launches(f"{tag}-nan", cfg, counts, _ft_steps_run(steps, rep, spans))
    losses = [h["loss"] for h in hist]
    if (losses != ref or rep["guard_trips"] != 1 or rep["rollbacks"] != 1
            or [t["event"] for t in rep["timeline"]] != ["guard:rollback", "rollback"]):
        raise AssertionError(f"{tag}-nan: report {rep}, losses {losses} vs {ref}")

    # (e) the same NaN skipped
    argv = [*_train_argv(dict(FT, steps=FT_SKIP_STEPS)), "--modules", "scan,metrics,ft",
            "--set", "ft.chaos.nan_at_step=3", "--set", "ft.guard_action=skip"]
    session, state, hist, counts, spans, _ = _ft_session(torch, argv, cfg, f"{tag}-skip")
    del state
    rep = session.results["ft"]
    _ft_launches(f"{tag}-skip", cfg, counts, _ft_steps_run(FT_SKIP_STEPS - 1, rep, spans))
    if (rep["guard_trips"] != 1 or rep["restarts"] or rep["rollbacks"]
            or [h["step"] for h in hist] != [1, 2, 3, 5, 6]
            or not math.isfinite(hist[-1]["loss"])):
        raise AssertionError(f"{tag}-skip: report {rep}, history {hist}")
    _free(torch)
    shutil.rmtree(root, ignore_errors=True)
    log(f"[{tag}] checkpoint costs in the chaos run: save_async stall median "
        f"{stall_ms:.1f} ms, restore median {restore_ms:.1f} ms ({smi})")
    return {"clean": ref}


def _ft_world_argv(job: str) -> list[str]:
    """The command lines of the ft world jobs: ``dp2`` (a crash and a
    degraded link at dp 2), ``one`` (the same chaos in one process),
    ``pp2`` (rank 1 slow at pp 2)."""
    base = [*_train_argv(FT_WORLD), "--modules", "scan,metrics,ft", *FT_DETECT]
    if job == "pp2":
        return [*base, *FT_PIPE, *FT_SLOW_STAGE]
    return [*base, "--ckpt-dir", str(RUNTIME_DIR / "ft-world" / job), "--ckpt-every",
            "3", "--set", "ft.chaos.crash_at_step=5", "--set", "ft.chaos.degrade_link=0-1",
            *(["--set", "parallel.dp=2"] if job == "dp2" else [])]


def ft_world_jobs() -> list[dict]:
    """The ft phase's jobs for the pipeline phase's world of 2 ranks: dp 2
    with a crash and a degraded link, and pp 2 with rank 1 slow, which
    replans to a wave schedule."""
    import shutil

    shutil.rmtree(RUNTIME_DIR / "ft-world", ignore_errors=True)
    return [dict(argv=_ft_world_argv(job), kernels=("flash_attention", "rmsnorm"),
                 model_cfg=_ft_cfg(), check=True) for job in ("dp2", "pp2")]


def _ft_pipeline_reference(torch, dev, cfg):
    """A one-process supervised run of the pp 2 job's plan and chaos: the
    loop with the pipelined step, the same per-rank events (rank 1 at half
    speed), the scan plugin's detector and a controller with
    ``slow_frac_hard=1.1``: ``(history, report)``."""
    from repro_torch.core.tracing import Tracer
    from repro_torch.ft import FtController, MitigationPolicy
    from repro_torch.obs import OnlineDetector, RankEventSpec
    from repro_torch.train.loop import LoopConfig, StepHooks, train

    plan = _plan_of([*_train_argv(FT_WORLD), *FT_PIPE])
    data, ocfg = _train_setup(cfg, FT_WORLD)
    ctl = FtController(policy=MitigationPolicy(slow_frac_hard=1.1))
    det = OnlineDetector(plan.topology(), every=4, window=64, align=False)

    def on_step(events, metrics):
        update = det.push(events)
        if update is not None:
            ctl.on_detection(update)

    state, hist = train(cfg, ocfg, data, LoopConfig(n_steps=FT_WORLD["steps"], seed=0),
                        plan=plan, device=dev, tracer=Tracer(rank=0, enabled=True),
                        obs=RankEventSpec(dp=1, pp=2, tp=1, slow_rank=1, slow_factor=0.5),
                        controller=ctl, hooks=StepHooks(on_step=on_step))
    del state
    _free(torch)
    return hist, ctl.report()


def ft_world_check(torch, dev, smi: str, rows: list[list[dict]],
                   tag: str = "ft-world") -> None:
    """The ft world jobs (:func:`ft_world_jobs`), each rank's row: dp 2
    restarts on both ranks at the crash and switches compression on at the
    same step on both; pp 2 replans to a wave on both stages, rank 0
    having decided; every rank's K1 and K2 launches exact for the steps it
    ran (:func:`_par_expected`); the ranks' losses equal; every step run,
    replays included, within ``STEP_LOSS_TOL`` of the fused one-process
    step from the same parameters (:class:`_StepRecorder`'s check), and
    each step of the history within it of a one-process supervised run of
    the same plan and chaos (dp 2: the plain step, whose sum over the
    batch the data ranks split; pp 2: the pipelined step in one
    process)."""
    import shutil

    cfg = _ft_cfg()
    steps = FT_WORLD["steps"]
    dp_rows, pp_rows = rows
    for name, ranks, cell in (("dp2", dp_rows, dict(dp=2)),
                              ("pp2", pp_rows, dict(pp=2, n_micro=2))):
        for r in ranks:
            ran = _ft_steps_run(steps, r["ft"], r["spans"])
            want = _par_expected(cfg, cell, r["coords"]["stage"], ran)
            log(f"[{tag}-{name}] rank {r['coords']}: steps run {ran}; launches "
                f"{r['launches']} expected {want}; timeline {json.dumps(r['ft']['timeline'])}; "
                f"online {r['online']}; losses {[h['loss'] for h in r['history']]}; "
                f"{_ft_medians(r['history'])} ({smi})")
            if r["launches"] != want:
                raise AssertionError(f"{tag}-{name} rank {r['coords']}: launches")
            if [h["step"] for h in r["history"]] != list(range(1, steps + 1)):
                raise AssertionError(f"{tag}-{name}: history steps")

    # dp 2: both ranks restart at the crash, compression on at the same step
    for r in dp_rows:
        rep = r["ft"]
        restarts = [t for t in rep["timeline"] if t["event"] == "restart"]
        if [t["details"]["reason"] for t in restarts] != ["InjectedCrash"]:
            raise AssertionError(f"{tag}-dp2: restarts {restarts}")
    on = [[t for t in r["ft"]["timeline"] if t["event"] == "mitigate:compress_on"]
          for r in dp_rows]
    if len(on[0]) != 1 or on[0] != on[1]:
        raise AssertionError(f"{tag}-dp2: compression on {on}")
    first = on[0][0]["step"] + 1
    log(f"[{tag}-dp2] rank 0: {_ft_medians(dp_rows[0]['history'], first)} ({smi})")
    _, state, one, _, _, _ = _ft_session(torch, _ft_world_argv("one"), cfg,
                                         f"{tag}-dp2-one-process")
    del state
    _free(torch)
    refs = {"dp2": [h["loss"] for h in one]}
    hist, rep = _ft_pipeline_reference(torch, dev, cfg)
    refs["pp2"] = [h["loss"] for h in hist]
    log(f"[{tag}-pp2-one-process] timeline {json.dumps(rep['timeline'])}; losses "
        f"{refs['pp2']}")

    # pp 2: the wave replan on both stages
    for r in pp_rows:
        rp = [t for t in r["ft"]["timeline"] if t["event"] == "mitigate:replan_schedule"]
        if (len(rp) != 1 or rp[0]["details"]["slow_ranks"] != [1]
                or rp[0]["details"]["wave"] < 1 or r["ft"]["restarts"]):
            raise AssertionError(f"{tag}-pp2 rank {r['coords']}: {r['ft']}")
    if pp_rows[0]["online"]["slow_ranks"] != [1] or pp_rows[1]["online"] is not None:
        raise AssertionError(f"{tag}-pp2: the detector's owner")
    for name, ranks in (("dp2", dp_rows), ("pp2", pp_rows)):
        r = ranks[0]
        # every step run, replays included, against the fused one-process
        # step from the same parameters (the parallel phase's check)
        each = [abs(x - ref[0][0]) for x, ref in zip(r["step_losses"], r["refs"])]
        traj = [abs(h["loss"] - x) for h, x in zip(r["history"], refs[name])]
        log(f"[{tag}-{name}] |dloss| a step run ({len(each)}) against the fused "
            f"one-process step from the same parameters: {[f'{x:.2e}' for x in each]} "
            f"(tol {STEP_LOSS_TOL}); trajectory against the one-process supervised "
            f"run: {[f'{x:.2e}' for x in traj]}")
        if (len(each) != _ft_steps_run(steps, r["ft"], r["spans"])
                or max(each) > STEP_LOSS_TOL or len(traj) != steps
                or max(traj) > STEP_LOSS_TOL):
            raise AssertionError(f"{tag}-{name}: losses off the one-process run")
        for other in ranks[1:]:
            if [h["loss"] for h in other["history"]] != [h["loss"] for h in r["history"]]:
                raise AssertionError(f"{tag}-{name}: the ranks' losses differ")
    shutil.rmtree(RUNTIME_DIR / "ft-world", ignore_errors=True)


# ------------------------------------------------ phases 10-13: MegaScope, MegaFBD

# probes of the scope phase: the widest tag (mlp_hidden, [8, 2048, 4864] a
# layer), a residual and a per-channel profile of the roped queries
SCOPE_PROBES = "mlp_hidden:stats,att_resid:stats,q:channels"
SCOPE_STEPS = 4
# the recurrent families' scope step: rwkv6-3b cut to 2 layers, Griffin to
# 3 (rec, rec, attn), both at full width
RWKV_SCOPE = dict(layers=2, seq_len=2048, global_batch=4, probes="wkv_decay:stats")
GRIFFIN_SCOPE = dict(layers=3, seq_len=4096, global_batch=2, probes="rglru_out:stats")
GEN = dict(prompt_len=128, steps=32, seed=1,
           probes=("final_hidden:stats", "attn_probs:full", "final_hidden:full"))
# a prompt past qwen2-0.5b's attn_kv_chunk (1024): the prefill takes the
# dense cache's chunked online softmax (layers._chunked_attention)
GEN_LONG = dict(prompt_len=1100, steps=4, seed=2, probes=("final_hidden:stats",))
# the recurrent families' generation: 128 tokens prefill as one chunked WKV
# segment (and one segment of MegaServe's driver), then one-token steps
GEN_RECURRENT = dict(prompt_len=128, steps=16, seed=1, probes=("final_hidden:stats",))
# stats_of on one layer's mlp_hidden, bf16, against float64: each statistic
# within STATS_RTOL of max(|reference|, 1) (float32 sums over 80 M
# elements); memory above the input under 4 B an element (a float32 copy
# alone is 4)
STATS_RTOL = 1e-4


class _KeepCaptures:
    """A plugin that keeps the last step's ``captures`` tree (on the card)."""

    name = "keep_captures"

    def __init__(self):
        self.captures = None

    def setup(self, session):
        return None

    def wrap_step(self, step_fn):
        return step_fn

    def on_step(self, session, events, metrics):
        self.captures = metrics.get("captures")

    def finalize(self, session):
        return {}


def _scope_session(argv: list[str], model_cfg=None):
    """:func:`_session` with a :class:`_KeepCaptures` after the plugins the
    arguments select; returns the session, the workload's result and the
    last step's captures."""
    from repro_torch.app.cli import parse
    from repro_torch.app.plugins import build_plugins
    from repro_torch.app.session import Session

    _, rc = parse(argv)
    keep = _KeepCaptures()
    session = Session(rc, plugins=[*build_plugins(rc.modules, rc), keep],
                      model_cfg=model_cfg)
    return session, session.run(), keep.captures


def _capture_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _capture_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _check_captures(torch, tag: str, captures: dict, n_groups: dict) -> int:
    """Every leaf finite with its segment's leading group axis; read back
    once.  Returns the number of leaves."""
    if not captures:
        raise AssertionError(f"{tag}: the step captured nothing")
    n = 0
    for seg, tree in captures.items():
        for path, leaf in _capture_leaves(tree):
            host = leaf.float().cpu()
            if seg != "top" and host.shape[0] != n_groups[seg]:
                raise AssertionError(f"{tag}: capture {seg}/{path} has shape "
                                     f"{tuple(host.shape)}, not [{n_groups[seg]}, ...]")
            if not torch.isfinite(host).all():
                raise AssertionError(f"{tag}: capture {seg}/{path} is not finite")
            n += 1
    return n


def stats_check(torch, smi: str, tag: str = "scope") -> None:
    """``stats_of`` on a bf16 tensor of one qwen2-0.5b layer's
    ``mlp_hidden`` at the train shape ([8, 2048, 4864], seed 3, with four
    values at the sparsity threshold): every statistic against float64
    within :data:`STATS_RTOL`, the sparsity count exact, the memory it
    takes above its input under a float32 copy's, and its time (CUDA
    events, after a warm-up)."""
    from repro_torch.core.scope.compress import stats_of

    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (TRAIN["global_batch"], TRAIN["seq_len"], 4864)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    x.view(-1)[:4] = torch.tensor([1.046875 * 2.0 ** -20, -1e-7, 2e-6, 0.0],
                                  device="cuda")
    xd = x.double()
    n = x.numel()
    ref = {"mean": xd.mean(), "std": xd.std(correction=0), "min": xd.min(),
           "max": xd.max(), "l2": torch.linalg.vector_norm(xd),
           "sparsity": torch.count_nonzero(xd.abs() < 1e-6).double() / n}
    del xd
    stats_of(x)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ours = stats_of(x)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(10):
        stats_of(x)
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / 10
    errs = {k: abs(ours[k].double().item() - ref[k].item()) / max(abs(ref[k].item()), 1.0)
            for k in ref}
    log(f"[{tag}] stats_of on bf16 {list(shape)}: {ms:.4f} ms (CUDA events, {smi}; one "
        f"read of the input is {1e3 * 2 * n / HBM_BYTES_PER_S:.4f} ms), {extra} bytes above "
        f"its input ({extra / n:.2f} an element), errors against float64 "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (limit {STATS_RTOL})")
    if max(errs.values()) > STATS_RTOL or round(ours["sparsity"].item() * n) != round(
            ref["sparsity"].item() * n) or extra >= 4 * n:
        raise AssertionError(f"{tag}: stats_of off on the card: {errs}, {extra} bytes")


def scope_phase(torch, smi: str, tag: str = "scope"):
    """MegaScope through the training forward: first :func:`stats_check`,
    then full-width qwen2-0.5b at the train phase's recipe, :data:`SCOPE_STEPS` steps through ``Session``
    with ``--modules scan,metrics,scope`` and :data:`SCOPE_PROBES`, and
    with ``--modules scan,metrics``, in turns (on, off, off, on).  Every
    run's losses must be bit-identical (probes never change numerics), K1's
    and K2's launches of a probed run equal to an unprobed run's, every
    capture finite with a leading axis of 24, the ``scope`` report one hit
    a step for every leaf.  Then one step with ``scope.perturbs``
    ``ffn_resid:offset:1.0:99`` (a layer that does not exist: the
    unperturbed first loss) and one with ``att_resid:gaussian:0.01`` (a
    different, finite loss).  Returns the K1 and K2 counts of the first
    probed run."""
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.models.lm import segment_layout

    stats_check(torch, smi, tag)
    torch.cuda.empty_cache()
    kernels = (flash_attention, rmsnorm)
    shape = dict(TRAIN, steps=SCOPE_STEPS)
    base = _train_argv(shape)
    on = [*base, "--modules", "scan,metrics,scope", "--set", f"scope.probes={SCOPE_PROBES}"]
    off = [*base, "--modules", "scan,metrics"]
    log(f"[{tag}] python -m repro_torch {' '.join(on)}; then {' '.join(off[-2:])}, "
        "in turns on, off, off, on")
    runs = []
    for probed in (True, False, False, True):
        for m in kernels:
            m.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        session, (state, history), caps = _scope_session(on if probed else off)
        torch.cuda.synchronize()
        counts = {k: v for m in kernels for k, v in m.launches.items()}
        peak = torch.cuda.max_memory_allocated()
        del state
        torch.cuda.empty_cache()
        runs.append(dict(probed=probed, session=session, history=history, caps=caps,
                         counts=counts, peak=peak))
    cfg = runs[0]["session"].model_cfg
    n_groups = {f"seg{i}": n for i, (_, n) in enumerate(segment_layout(cfg))}
    losses = [[h["loss"] for h in r["history"]] for r in runs]
    for r in runs:
        med = statistics.median(h["step_s"] for h in r["history"][1:])
        log(f"[{tag}] {'--modules scan,metrics,scope' if r['probed'] else '--modules scan,metrics':28s} "
            f"losses {[h['loss'] for h in r['history']]} median step {1e3 * med:.1f} ms "
            f"(steps " + ", ".join(f"{1e3 * h['step_s']:.1f}" for h in r["history"][1:])
            + f"); launches {r['counts']}; max_memory_allocated={r['peak']}")
    if any(x != losses[0] for x in losses):
        raise AssertionError(f"{tag}: losses under probes differ from those without: {losses}")
    for r in runs[1:]:
        if r["counts"] != runs[0]["counts"]:
            raise AssertionError(f"{tag}: K1/K2 launches {r['counts']} != {runs[0]['counts']}")
    for r in runs:
        if not r["probed"]:
            continue
        n = _check_captures(torch, tag, r["caps"], n_groups)
        report = r["session"].results["scope"]
        if not report["captured"] or set(report["captured"].values()) != {SCOPE_STEPS} \
                or len(report["captured"]) != n:
            raise AssertionError(f"{tag}: scope report {report}")
    log(f"[{tag}] {len(runs[0]['session'].results['scope']['captured'])} capture leaves a "
        f"step, each [{cfg.num_layers}, ...] and finite, counted {SCOPE_STEPS} times "
        f"({', '.join(sorted({k.split('/')[1] for k in runs[0]['session'].results['scope']['captured']}))})")
    pooled = {p: [h["step_s"] for r in runs if r["probed"] == p for h in r["history"][1:]]
              for p in (True, False)}
    log(f"[{tag}] steps 2-{SCOPE_STEPS} pooled over two runs each: median with scope "
        f"{1e3 * statistics.median(pooled[True]):.1f} ms, without "
        f"{1e3 * statistics.median(pooled[False]):.1f} ms; peak memory with scope "
        f"{max(r['peak'] for r in runs if r['probed'])}, without "
        f"{max(r['peak'] for r in runs if not r['probed'])} bytes ({smi})")

    one = [*_train_argv(dict(TRAIN, steps=1)), "--modules", "scope"]
    for spec, same in (("ffn_resid:offset:1.0:99", True), ("att_resid:gaussian:0.01", False)):
        _, (state, hist) = _session([*one, "--set", f"scope.perturbs={spec}"])
        del state
        torch.cuda.empty_cache()
        loss = hist[0]["loss"]
        log(f"[{tag}] one step with scope.perturbs={spec}: loss {loss!r}, unperturbed "
            f"{losses[0][0]!r}")
        if same and loss != losses[0][0]:
            raise AssertionError(f"{tag}: a perturbation of no layer moved the loss")
        if not same and (loss == losses[0][0] or not math.isfinite(loss)):
            raise AssertionError(f"{tag}: the gaussian perturbation left the loss {loss}")
    return runs[0]["counts"]


def recurrent_scope_phase(torch, smi: str, tag: str = "scope-recurrent") -> None:
    """One train step of rwkv6-3b (:data:`RWKV_SCOPE`) and of
    recurrentgemma-9b (:data:`GRIFFIN_SCOPE`), at full width cut in depth,
    with their probe and without: losses bit-identical, K5 (rwkv6) and K6
    and K2 (Griffin) and K1 launched as often, captures finite."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, rglru, rmsnorm, wkv6
    from repro_torch.models.lm import segment_layout

    for arch, shp, kernels in (("rwkv6-3b", RWKV_SCOPE, (wkv6, rmsnorm)),
                               ("recurrentgemma-9b", GRIFFIN_SCOPE,
                                (rglru, flash_attention, rmsnorm))):
        cfg = get_config(arch).replace(num_layers=shp["layers"])
        argv = ["train", "--arch", arch, "--seq-len", str(shp["seq_len"]),
                "--global-batch", str(shp["global_batch"]), "--steps", "1"]
        out = {}
        for probed in (True, False):
            mods = (["--modules", "scope", "--set", f"scope.probes={shp['probes']}"]
                    if probed else ["--modules", "none"])
            for m in kernels:
                m.reset_launches()
            _, (state, hist), caps = _scope_session([*argv, *mods], model_cfg=cfg)
            torch.cuda.synchronize()
            del state
            torch.cuda.empty_cache()
            out[probed] = (hist[0]["loss"], {k: v for m in kernels for k, v in m.launches.items()},
                           caps)
        n_groups = {f"seg{i}": n for i, (_, n) in enumerate(segment_layout(cfg))}
        n = _check_captures(torch, f"{tag} {arch}", out[True][2], n_groups)
        keys = sorted(k for tree in out[True][2].values() for k in tree)
        log(f"[{tag}] {arch} at {shp['layers']} layers, seq {shp['seq_len']} x batch "
            f"{shp['global_batch']}, probe {shp['probes']}: loss {out[True][0]!r} with, "
            f"{out[False][0]!r} without; launches {out[True][1]} with, {out[False][1]} "
            f"without; {n} capture leaves ({', '.join(keys)})")
        if out[True][0] != out[False][0]:
            raise AssertionError(f"{tag} {arch}: the probe changed the loss")
        if out[True][1] != out[False][1] or not all(out[True][1].values()):
            raise AssertionError(f"{tag} {arch}: launches {out[True][1]} != {out[False][1]}")


def _dense_replay(torch, cfg, params, prompt: list[int], forced: list[int], *,
                  plain: bool = False, cache_len: int | None = None):
    """Teacher-forced logits ``[len(forced), V]`` over the dense cache
    (the path ``generate_with_scope`` and MegaServe's gathered path take):
    prefill ``prompt``, then feed ``forced[:-1]`` one token at a time, over
    a cache of ``cache_len`` positions (default: just long enough), through
    the kernels or (``plain``) the plain versions."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    dev = params["embedding"].device
    cache = lm.init_cache(cfg, 1, cache_len or len(prompt) + len(forced), device=dev)
    with torch.no_grad():
        hidden, _ = lm.forward(cfg, params, torch.tensor([prompt], device=dev),
                               cache=cache, cache_pos=0, plain=plain)
        out = [L.logits_fn(params, cfg, hidden[:, -1:])[0, 0]]
        for i, tok in enumerate(forced[:-1]):
            hidden, _ = lm.forward(cfg, params, torch.tensor([[tok]], device=dev),
                                   cache=cache, cache_pos=len(prompt) + i, plain=plain)
            out.append(L.logits_fn(params, cfg, hidden)[0, 0])
    return torch.stack(out).float()


def _generate_case(torch, cfg, srv, case: dict, smi: str, tag: str):
    """One ``generate_with_scope`` run of ``case`` (a :data:`GEN`-like
    dict) after a warm-up, held as :func:`generate_phase` says; returns
    its records.  Counts the calls of the dense cache's chunked attention
    (``layers._chunked_attention``) in the timed run: one a layer where the
    prefill's cache exceeds ``attn_kv_chunk``, else none."""
    import numpy as np

    from repro_torch.core.scope import ProbeSpec, ScopeCollector, generate_with_scope
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.models import layers
    from repro_torch.models.lm import segment_layout

    rng = np.random.default_rng(case["seed"])
    prompt = rng.integers(0, cfg.vocab_size, case["prompt_len"]).tolist()
    srv.reset()
    rid = srv.submit(prompt, case["steps"], arrival=0.0)
    stream = srv.drain()[rid]
    probes = [ProbeSpec(*p.split(":")) for p in case["probes"]]
    toks = torch.tensor([prompt], device=srv.device)
    generate_with_scope(cfg, srv.params, toks, 2, ScopeCollector(probes=probes))  # warm-up
    flash_attention.reset_launches()
    rmsnorm.reset_launches()
    chunked, inner = [0], layers._chunked_attention

    def counted(*args, **kwargs):
        chunked[0] += 1
        return inner(*args, **kwargs)

    layers._chunked_attention = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records, out = generate_with_scope(cfg, srv.params, toks, case["steps"],
                                           ScopeCollector(probes=probes))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        layers._chunked_attention = inner
    counts = {**flash_attention.launches, **rmsnorm.launches}
    ours = out[0].tolist()
    L_ = cfg.num_layers
    T = case["prompt_len"] + case["steps"]
    n_attn = sum(k in ("dense", "attn") for pat, n in segment_layout(cfg)
                 for _ in range(n) for k in pat)
    want_chunked = n_attn if T > cfg.attn_kv_chunk else 0
    want_norm = (2 * L_ + 1) * (case["steps"] + 1)
    log(f"[{tag}] {cfg.name} {L_} layers, prompt {case['prompt_len']} (seed {case['seed']}), "
        f"{case['steps']} steps: {1e3 * dt / case['steps']:.2f} ms per generated token on the "
        f"host clock (prefill included; {1e3 * dt:.1f} ms in all, {smi}); launches {counts}, "
        f"expected rmsnorm_fwd (2x{L_}+1)x{case['steps'] + 1}={want_norm}, no flash; "
        f"chunked kv_len attention {chunked[0]} calls (cache {T} vs attn_kv_chunk "
        f"{cfg.attn_kv_chunk}: expected {want_chunked})")
    if counts["rmsnorm_fwd"] != want_norm or counts["rmsnorm_bwd"] or any(
            counts[k] for k in flash_attention.launches) or chunked[0] != want_chunked:
        raise AssertionError(f"{tag}: launches {counts}, chunked attention {chunked[0]}")
    if [r.token for r in records] != ours or len(ours) != case["steps"]:
        raise AssertionError(f"{tag}: records and tokens disagree")
    part = next((i for i, (a, b) in enumerate(zip(ours, stream)) if a != b), None)
    lk = replay(torch, cfg, srv.params, prompt, ours, plain=False)
    ld = _dense_replay(torch, cfg, srv.params, prompt, ours)
    V = cfg.vocab_size
    err = (lk[:, :V] - ld[:, :V]).abs().max().item()
    idx = torch.tensor(ours, device=lk.device)[:, None]
    gap = (lk[:, :V].max(-1).values - lk.gather(1, idx)[:, 0]).max().item()
    dense_greedy = bool((ld[:, :V].argmax(-1) == idx[:, 0]).all())
    log(f"[{tag}] tokens {'equal to' if part is None else f'part from (at step {part})'} "
        f"MegaServe's greedy stream; teacher-forced logits, serving kernels vs dense "
        f"cache: max err {err:.4f}, serving path's max minus the chosen token's {gap:.4f} "
        f"(tol {LOGIT_TOL}); dense replay greedy on the tokens: {dense_greedy}")
    if not (err <= LOGIT_TOL and gap <= LOGIT_TOL and dense_greedy
            and torch.isfinite(lk).all() and torch.isfinite(ld).all()):
        raise AssertionError(f"{tag}: generation off the serving path beyond {LOGIT_TOL}")
    return records


def generate_phase(torch, cfg, srv, smi: str, tag: str = "generate") -> None:
    """``generate_with_scope`` on full-width qwen2-0.5b (the serve phase's
    seed-0 weights, bf16), twice: a :data:`GEN` prompt, greedy steps,
    probes on the final hidden state and the attention probabilities; and
    a :data:`GEN_LONG` prompt past ``attn_kv_chunk``, whose prefill takes
    the chunked ``kv_len`` attention.  Each run's tokens against
    MegaServe's greedy stream for the same prompt; the teacher-forced
    logits of its tokens through the serving kernels (K4, K3) and through
    its dense cached path within ``LOGIT_TOL``, and where the streams
    part, the serving path's own choice within ``LOGIT_TOL`` of the dense
    path's.  K1 launches once a norm a forward; no K2 (JAX takes
    ``_make_flash`` there, outside Pallas).  Then a dashboard from the
    first run's last ``attn_probs`` and a PCA of its final hidden states."""
    from dataclasses import replace

    import numpy as np

    from repro_torch.core.scope import pca_fit, pca_project, write_dashboard

    records = _generate_case(torch, cfg, srv, GEN, smi, tag)
    _generate_case(torch, cfg, srv, GEN_LONG, smi, tag)

    attn = records[-1].captures["attn_probs.full"]            # [L, 1, 1, K, G, T]
    heat = attn[-1].reshape(-1, attn.shape[-1])
    hidden = np.concatenate([r.captures["final_hidden.full"].reshape(-1, cfg.d_model)
                             for r in records])
    fit = pca_fit(hidden, k=2)
    # the records' stats only: the full captures above would make ~20 MB of JSON
    light = [replace(r, captures={k: v for k, v in r.captures.items()
                                  if k.endswith(".stats")}) for r in records]
    path = write_dashboard(RUNTIME_DIR / "dashboard.html", light, attention=heat,
                           pca_points=pca_project(hidden, fit), meta=f"{cfg.name} ({smi})")
    html = path.read_text()
    ok = "MegaScope dashboard" in html and "const DATA" in html and len(html) > 2000
    log(f"[{tag}] dashboard {path.relative_to(REPO)}: {len(html)} bytes, attention "
        f"{tuple(heat.shape)} of the last layer, PCA of {hidden.shape[0]} final hidden "
        f"states (explained {fit['explained']}); markers {'found' if ok else 'MISSING'}")
    if not ok or not np.isfinite(heat).all() or abs(heat.sum(-1) - 1).max() > 1e-3:
        raise AssertionError(f"{tag}: dashboard or attention probabilities off")


def recurrent_generate_phase(torch, smi: str, tag: str = "generate-recurrent") -> None:
    """``generate_with_scope`` on rwkv6-3b and recurrentgemma-9b at full
    width, cut in depth as the scope phases are (2 layers; 3: rec, rec,
    attn), seed-0 weights, bf16, over the dense cache's carried state: a
    :data:`GEN_RECURRENT` prompt, greedy steps, held as
    :func:`generate_phase` holds qwen2's against a MegaServe of the same
    weights (its greedy stream, the teacher-forced logits through the
    serving path and through the dense cache)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.paged_cache import blocks_for
    from repro_torch.serve.scheduler import ServeConfig
    from repro_torch.serve.server import MegaServe

    for arch, layers in (("rwkv6-3b", RWKV_SCOPE["layers"]),
                         ("recurrentgemma-9b", GRIFFIN_SCOPE["layers"])):
        cfg = get_config(arch).replace(num_layers=layers)
        params = lm.init(cfg, seed=0, device="cuda")
        blocks = blocks_for(GEN_RECURRENT["prompt_len"] + GEN_RECURRENT["steps"], BS)
        srv = MegaServe(cfg, params, ServeConfig(
            num_slots=2, block_size=BS, num_blocks=2 * blocks + 1,
            max_blocks_per_slot=blocks), device="cuda")
        del params
        _generate_case(torch, cfg, srv, GEN_RECURRENT, smi, f"{tag} {arch}")
        del srv
        gc.collect()
        torch.cuda.empty_cache()


def fbd_hand_count(cfg, B: int, S: int, *, batch_mask: bool) -> int:
    """Residual bytes of the qwen2 loss under remat full on the card, by
    hand: each layer's input (bf16 [B, S, D], what checkpoint keeps), the
    positions (int64 [S], once), K1's input to the final norm and its rstd
    (float32 [B*S]), the chunked cross entropy's input (bf16 [B, S, D]),
    its mask (float32 [B, S]) unless the batch brings a float32
    ``loss_mask`` (``batch_mask``; ``SyntheticTokens`` does), and three
    float32 scalars of the mean.  Parameters and batch leaves are no
    residuals."""
    D = cfg.d_model
    return (cfg.num_layers * B * S * D * 2 + S * 8 + B * S * D * 2 + B * S * 4
            + B * S * D * 2 + (0 if batch_mask else B * S * 4) + 3 * 4)


def fbd_phase(torch, dev, smi: str, tag: str = "fbd") -> None:
    """MegaFBD's decoupled step on full-width qwen2-0.5b at the train
    phase's shape, remat full, from the seed-0 parameters and batch 0: the
    fused loss and gradients (``torch.autograd.grad``), then the same
    through ``make_decoupled_step``, then again with the residuals moved
    to host memory and back between ``fwd`` and ``bwd``.  Loss and every
    gradient leaf bit-identical each time, and the decoupled run's K1 and
    K2 launches equal the fused run's; ``fwd`` and ``bwd`` timed with CUDA
    events; ``residual_bytes`` equal to :func:`fbd_hand_count`; and the
    ``fbd`` plugin's report."""
    import types

    from repro_torch.app.config import build_run_config
    from repro_torch.app.plugins import FbdPlugin
    from repro_torch.configs import get_config
    from repro_torch.core.fbd import make_decoupled_step
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.models import lm
    from repro_torch.train.optim import leaves
    from repro_torch.train.train_step import init_train_state, to_device_batch

    cfg = get_config("qwen2-0.5b").replace(remat="full")
    data, _ = _train_setup(cfg, TRAIN)
    state = init_train_state(cfg, seed=0, device=dev)
    params = state.params
    del state
    batch = to_device_batch(SyntheticTokens(data).batch_at(0), dev)
    flat = [p for _, p in leaves(params)]
    loss_fn = lambda p, b: lm.loss_fn(cfg, p, b)[0]  # noqa: E731
    kernels = (flash_attention, rmsnorm)

    def counted(fn):
        for m in kernels:
            m.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for m in kernels for k, v in m.launches.items()}

    def fused():
        loss = loss_fn(params, batch)
        return loss.detach(), torch.autograd.grad(loss, flat)

    counted(fused)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    (ref_loss, ref), fused_counts = counted(fused)
    fused_peak = torch.cuda.max_memory_allocated()
    step = make_decoupled_step(loss_fn)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def decoupled(host: bool):
        ev[0].record()
        loss, res = step.fwd(params, batch)
        ev[1].record()
        moved = 0.0
        if host:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res.to("cpu")
            res.to(dev)
            torch.cuda.synchronize()
            moved = time.perf_counter() - t0
            ev[1].record()
        nbytes = res.nbytes
        grads = step.bwd(params, batch, res, torch.ones_like(loss))
        ev[2].record()
        return loss, grads, nbytes, moved

    torch.cuda.reset_peak_memory_stats()
    (loss, grads, nbytes, _), dec_counts = counted(lambda: decoupled(False))
    dec_peak = torch.cuda.max_memory_allocated()
    fwd_ms, bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    hand = fbd_hand_count(cfg, data.global_batch, data.seq_len,
                          batch_mask=batch["loss_mask"].dtype == torch.float32)

    def same(loss, grads) -> list[str]:
        bad = [".".join(p) for (p, g), r in zip(leaves(grads), ref) if not torch.equal(g, r)]
        return bad + (["loss"] if not torch.equal(loss, ref_loss) else [])

    bad = same(loss, grads)
    del grads
    (loss2, grads2, _, moved), _ = counted(lambda: decoupled(True))
    bad2 = same(loss2, grads2)
    del grads2
    report = FbdPlugin(build_run_config("train"))
    report.setup(types.SimpleNamespace())
    log(f"[{tag}] {cfg.name} remat full, seq {data.seq_len} x batch {data.global_batch}: "
        f"loss {ref_loss.item()!r}; decoupled fwd {fwd_ms:.2f} ms, bwd {bwd_ms:.2f} ms (CUDA "
        f"events; {smi}); residual_bytes {nbytes} against a hand count of {hand}; "
        f"round trip of the residuals through host memory {1e3 * moved:.1f} ms; peak memory "
        f"fused {fused_peak}, decoupled {dec_peak}")
    log(f"[{tag}] launches fused {fused_counts}, decoupled {dec_counts}; leaves differing: "
        f"direct {bad or 'none'}, after the host round trip {bad2 or 'none'} of {len(ref)}; "
        f"fbd plugin report {report.finalize(None)}")
    if bad or bad2:
        raise AssertionError(f"{tag}: decoupled grads differ from fused: {bad} / {bad2}")
    if dec_counts != fused_counts or not all(fused_counts.values()):
        raise AssertionError(f"{tag}: launches {dec_counts} != fused {fused_counts}")
    if nbytes != hand:
        raise AssertionError(f"{tag}: residual_bytes {nbytes} != hand count {hand}")
    del params, flat, ref
    torch.cuda.empty_cache()


def _in_float64(fn):
    """``fn`` (the model's WKV or RG-LRU call) with its plain version
    evaluated in float64 on the same inputs, outputs back in float32: the
    noise probe below."""
    import torch

    def call(*args, plain=False):
        outs = fn(*(t.double() if isinstance(t, torch.Tensor) else t for t in args),
                  plain=True)
        return tuple(t.float() for t in outs)
    return call


def _leaf_norms(grads: dict, mixer: str | tuple[str, ...]) -> dict:
    """Per layer, the gradient norm of every leaf of the token mixer
    (``mixer``: attention, time mix or Griffin's mix; several names, as the
    encoder-decoder's ``attn`` and ``cross``) and of every norm scale;
    layer-stacked leaves (segments, the encoder's and decoder's) carry the
    layer on axis 0."""
    from repro_torch.train.optim import leaves

    mixers = (mixer,) if isinstance(mixer, str) else mixer
    stacked = lambda root: root.startswith("seg") or root in ("encoder", "decoder")  # noqa: E731
    return {".".join(path): (g.float().flatten(1).norm(dim=1)
                             if stacked(path[0]) else g.float().norm())
            for path, g in leaves(grads)
            if any(m in path for m in mixers) or path[-1] == "scale"}


def _loss_split(torch, dev, cfg, params, batch, base: float, probe: tuple, tag: str,
                draws: int = 2) -> None:
    """Log how the step check's loss gap splits: the plain path with only
    ``probe``'s call on its kernel, the kernel path with only that call
    plain, and the kernel path with that call's output scaled by ``1 + 1e-6
    N(0, 1)`` (seeded), which is how far a float32 rounding change in that
    output moves the loss through the bf16 model.  Losses only, no
    gradients; ``base`` is the plain path's loss."""
    from repro_torch.models import lm

    real = getattr(*probe)
    gen = torch.Generator(device=dev).manual_seed(0)

    def on_kernel(kernel: bool):
        return lambda *a, plain=False: real(*a, plain=not kernel)

    def jittered(*a, plain=False):
        y, *rest = real(*a, plain=plain)
        noise = torch.randn(y.shape, generator=gen, device=y.device)
        return (y * (1 + 1e-6 * noise), *rest)

    runs = [(f"only {probe[1]} on its kernel", True, on_kernel(True)),
            (f"all but {probe[1]} on the kernels", False, on_kernel(False))] + [
        (f"kernels, {probe[1]} x (1 + 1e-6 N(0, 1)) draw {i}", False, jittered)
        for i in range(draws)]
    parts = []
    for what, plain, fn in runs:
        setattr(*probe, fn)
        try:
            with torch.no_grad():
                loss = lm.loss_fn(cfg, params, batch, plain=plain)[0].item()
        finally:
            setattr(*probe, real)
        parts.append(f"{what} {loss - base:+.2e}")
    log(f"[{tag}] loss minus the plain path's: " + "; ".join(parts))


def step_check(torch, dev, cfg, data, *, mixer: str, tag: str, batch_step: int,
               tols: tuple[float, float, float], probe: tuple | None = None,
               pipeline: dict | None = None, batch: dict | None = None,
               pin_routing: bool = False, flips_above_noise: bool = False) -> None:
    """The loss and gradients of one batch, from the bfloat16 parameters of
    seed 0, through the kernels and through the plain versions: loss,
    global gradient norm and :func:`_leaf_norms`, held to ``tols``
    (absolute loss, relative grad_norm, relative leaf norm).  A train step
    would add AdamW, the same code on both sides.  ``probe`` =
    (module, name) also runs the plain path with only that module's
    ``name`` call evaluated in float64 and logs how far that moves the same
    numbers, the bf16 noise floor of the comparison, and splits the loss gap
    (:func:`_loss_split`).  ``pipeline`` (``pipeline_loss``'s layout, table,
    stages and n_micro) compares the pipelined loss with the fused one
    instead, both through the kernels.  ``batch`` (on the device) replaces
    ``data``'s batch; ``pin_routing`` (MoE) routes the plain run's tokens
    to the experts the kernel run picked (:class:`_PinnedRouting`) and holds
    how many it would have routed otherwise (:func:`_check_flips`, with
    ``flips_above_noise`` its ``above_noise``)."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import pipeline as pl
    from repro_torch.models.model import get_model
    from repro_torch.train.optim import global_norm
    from repro_torch.train.train_step import (
        compute_params, grad_tree, to_device_batch, unused_leaves)

    model = get_model(cfg)
    params = compute_params(model.init(cfg, seed=0, device=dev), torch.bfloat16)
    if batch is None:
        batch = to_device_batch(SyntheticTokens(data).batch_at(batch_step), dev)
    pin = _PinnedRouting() if pin_routing else contextlib.nullcontext()
    res = {}
    names = (("pipelined", "fused") if pipeline else
             ("kernels", "plain") + (("probe",) if probe else ()))
    with pin:
        for run in names:
            if run == "probe":
                real = getattr(*probe)
                setattr(*probe, _in_float64(real))
            if run == "plain" and pin_routing:
                pin.replay()
            try:
                if run == "pipelined":
                    loss, _ = pl.pipeline_loss(cfg, params, batch, **pipeline)
                else:
                    loss, _ = model.loss_fn(cfg, params, batch,
                                            plain=run not in ("kernels", "fused"))
                tree = grad_tree(params, loss, unused_leaves(cfg))
            finally:
                if run == "probe":
                    setattr(*probe, real)
            res[run] = (loss.item(), global_norm(tree).item(), _leaf_norms(tree, mixer))
            del loss, tree
            torch.cuda.empty_cache()
    if pin_routing:
        with torch.no_grad(), _PinnedRouting() as noise:
            model.loss_fn(cfg, params, batch, plain=True)
            noise.replay()
            with _Float64Norms():
                model.loss_fn(cfg, params, batch, plain=True)
        _check_flips(tag, pin, noise, above_noise=flips_above_noise)

    def gaps(a, b):
        (la, ga, na), (lb, gb, nb) = res[a], res[b]
        return abs(la - lb), abs(ga - gb) / gb, {
            name: ((na[name] - nb[name]).abs() / nb[name]).max().item() for name in nb}

    loss_tol, gnorm_rtol, leaf_rtol = tols
    (lk, gk, _), (lp, gp, _) = res[names[0]], res[names[1]]
    d_loss, d_gn, d_leaf = gaps(*names[:2])
    if probe:
        p_loss, p_gn, p_leaf = gaps("probe", "plain")
        worst = max(p_leaf, key=p_leaf.get)
        log(f"[{tag}] noise probe, plain path with its {probe[1]} in float64 vs float32: "
            f"|dloss|={p_loss:.2e} rel dgrad_norm={p_gn:.2e} largest leaf "
            f"{worst}={p_leaf[worst]:.2e}")
    ok = (d_loss <= loss_tol and d_gn <= gnorm_rtol
          and max(d_leaf.values()) <= leaf_rtol and math.isfinite(lk))
    log(f"[{tag}] {cfg.name} ({cfg.num_layers} layers) {names[0]} loss={lk:.5f} "
        f"grad_norm={gk:.5f}; {names[1]} loss={lp:.5f} grad_norm={gp:.5f}; "
        f"|dloss|={d_loss:.2e} (tol {loss_tol}) "
        f"rel dgrad_norm={d_gn:.2e} (tol {gnorm_rtol})")
    log(f"[{tag}] per-layer leaf gradient norms, largest relative difference: "
        + " ".join(f"{n}={e:.2e}" for n, e in sorted(d_leaf.items()))
        + f" (tol {leaf_rtol}) {'ok' if ok else 'FAIL'}")
    if probe:
        _loss_split(torch, dev, cfg, params, batch, lp, probe, tag)
    del params
    if not ok:
        raise AssertionError(f"{tag}: the {names[0]} loss and gradients disagree "
                             f"with the {names[1]} ones")


# ------------------------------------------------ the pipeline (MegaDPP)

# qwen2-0.5b at full width and depth through 2 stages of 2 chunks (4 cells
# of 6 layers) and 4 microbatches of 2 rows, at the train phase's seq 2048
# x batch 8; the schedule sweep at the same shape and depth, 6 steps each
PIPE = dict(pp=2, n_chunks=2, n_micro=4)
PIPE_STEPS = 4
PIPE_FBD_STEPS = 2
PIPE_SWEEP_STEPS = 4
PIPE_SCHEDULES = ("1f1b", "dfc", "bfc", "wave")
# rwkv6-3b at full width cut to 4 layers (one a cell) at seq 2048 x batch
# 4: 4 microbatches of one row
PIPE_RWKV = dict(seq_len=2048, global_batch=4, steps=4, seed=0)
PIPE_RWKV_LAYERS = 4


def _pipe_argv(shape: dict, schedule: str, modules: str, arch: str = "qwen2-0.5b"):
    return ["train", "--arch", arch, "--seq-len", str(shape["seq_len"]),
            "--global-batch", str(shape["global_batch"]),
            "--steps", str(shape["steps"]), "--seed", str(shape["seed"]),
            "--pp", str(PIPE["pp"]), "--n-micro", str(PIPE["n_micro"]),
            "--set", f"parallel.n_chunks={PIPE['n_chunks']}",
            "--pp-schedule", schedule, "--modules", modules]


def _counted_session(torch, argv: list[str], modules: tuple, model_cfg=None):
    """``_session`` (one process) with every kernel of ``modules`` counted
    from 0 and the peak memory reset: ``(session, state, history, counts,
    peak)``."""
    for m in modules:
        m.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    session, (state, history) = _session(argv, model_cfg)
    torch.cuda.synchronize()
    return (session, state, history,
            {k: v for m in modules for k, v in m.launches.items()},
            torch.cuda.max_memory_allocated())


def _world(jobs: list[dict], nprocs: int, tag: str) -> list[list[dict]]:
    """Spawn ``nprocs`` ranks on the card that run ``jobs`` in turn
    (:func:`_world_rank`); for each job, every rank's row in rank order."""
    from repro_torch.parallel import dist as pdist

    t0 = time.perf_counter()
    per_rank = pdist.spawn(_world_rank, (jobs,), nprocs, device="cuda")
    log(f"[{tag}] a world of {nprocs} ranks: {len(jobs)} runs in "
        f"{time.perf_counter() - t0:.1f} s, spawning included")
    for rank, r in enumerate(per_rank):
        log(f"[{tag}] rank {rank}'s first calls: " + ", ".join(
            f"{k} {1e3 * v:.1f} ms" for k, v in r[0]["first_calls"].items())
            + f"; its first step {1e3 * r[0]['history'][0]['step_s']:.1f} ms")
    for rank, r in enumerate(per_rank):
        log(f"[{tag}] rank {rank}'s first step under the Python profiler:\n"
            + r[0]["first_profile"])
    return [[r[i] for r in per_rank] for i in range(len(jobs))]


def _world_rank(jobs: list[dict]) -> list[dict]:
    """One rank of a world spawned for ``jobs``: each job's command line
    (``argv``, with ``model_cfg`` if given) through a ``Session`` in this
    rank's world, as ``python -m repro_torch`` runs it under ``torchrun``,
    with the kernels of ``kernels`` counted from 0 and
    :class:`_StepRecorder` on (``check``: each step's reference).  The
    master of a job with ``keep`` is kept for the next job with
    ``compare``, which lists the leaves of its own master that differ."""
    import importlib

    import torch

    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.app.cli import parse
    from repro_torch.app.session import Session
    from repro_torch.train.optim import leaves

    out, kept = [], None
    warm = _first_calls(torch)
    for job in jobs:
        mods = [importlib.import_module(f"repro_torch.kernels.{k}") for k in job["kernels"]]
        for m in mods:
            m.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        _, rc = parse(job["argv"])
        with _StepRecorder(check=job.get("check", False), first=not out) as rec:
            session = Session(rc, model_cfg=job.get("model_cfg"))
            state, history = session.run()
        torch.cuda.synchronize()
        res = session.results
        row = {"history": history, "coords": res["parallel"]["coords"],
               "backend": res["parallel"]["backend"],
               "launches": {k: v for m in mods for k, v in m.launches.items()},
               "peak": rec.peak if job.get("check") else torch.cuda.max_memory_allocated(),
               "sync_s": rec.sync_s,
               "check_s": rec.check_s, "norms": rec.norms, "refs": rec.refs,
               "step_losses": rec.losses,
               "first_calls": warm, "first_profile": rec.first_profile,
               "digest": {".".join(p): (t.double().sum().item(),
                                        t.double().square().sum().item())
                          for p, t in leaves(state.master)}}
        if not any(row["coords"].values()):
            row["results"] = {k: res[k] for k in ("parallel", "dpp") if k in res}
        if "ft" in res:  # the ft phase's jobs
            row["ft"] = res["ft"]
            row["online"] = res["scan"].get("online")
            row["spans"] = sum(e.name == "train_step" for e in session.tracer.events)
        if job.get("compare"):
            row["differing"] = [".".join(p) for p, t in leaves(state.master)
                                if not torch.equal(t, kept[p])]
        kept = ({p: t.clone() for p, t in leaves(state.master)}
                if job.get("keep") else None)
        out.append(row)
        del state, session, res
        _free(torch)
    return out


def _first_calls(torch) -> dict:
    """Seconds of a new rank's first calls, each after the one before
    (synchronised): its first tensor on the card, a cuBLAS product, K1
    (Triton, from the cache its parent filled), K2's forward and backward
    (the CUDA library), a gloo all-reduce over the world, and the same
    calls once more.  A rank's first train step pays whatever of this its
    run had not paid yet."""
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.parallel import dist as pdist

    dev = pdist.world().device
    out: dict = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[name] = out.get(name, 0.0) + time.perf_counter() - t0

    def calls(tag: str) -> None:
        timed(f"{tag}tensor", lambda: torch.ones(1, device=dev))
        x = torch.randn(256, D_MODEL, device=dev, dtype=torch.bfloat16)
        timed(f"{tag}cublas", lambda: x @ x.T)
        timed(f"{tag}k1", lambda: rmsnorm(x, torch.ones(D_MODEL, device=dev)))
        q = torch.randn(1, 256, H, DH, device=dev, dtype=torch.bfloat16, requires_grad=True)
        kv = torch.randn(1, 256, K, DH, device=dev, dtype=torch.bfloat16)
        timed(f"{tag}k2", lambda: flash_attention(q, kv, kv, scale=DH ** -0.5).sum()
              .backward())
        timed(f"{tag}gloo", lambda: dist.all_reduce(torch.ones(1, device=dev)))

    calls("")
    calls("again ")
    return out


def _par_expected(cfg, cell: dict, stage: int, steps: int) -> dict:
    """A rank's launches over ``steps`` steps (remat full: a layer's
    forward, its recompute and its backward a microbatch).  dp and tp
    ranks run every layer once a step, as the fused step does
    (:func:`per_step_launches`).  A pipeline stage runs its ``L / pp``
    layers once per microbatch of its dp group, stage 0 also the final
    norm; under MegaFBD the stage's forward runs here and the previous
    stage's backward too, whose graph it rebuilds with one more
    forward."""
    pp = cell.get("pp", 1)
    if pp == 1:
        return {k: steps * v for k, v in per_step_launches(cfg).items()}
    per = per_step_launches(cfg.replace(num_layers=cfg.num_layers // pp),
                            cell["n_micro"] // cell.get("dp", 1))
    head = {k: 1 for k in per if k.startswith("rmsnorm")}  # the final norm
    out = {}
    for k, v in per.items():
        v -= head.get(k, 0)
        if cell.get("fbd") and k.endswith("_fwd"):
            v = v * 3 // 2  # the rebuild of the previous stage's forward
        out[k] = steps * (v + (head.get(k, 0) if stage == 0 else 0))
    return out


def _check_world_launches(tag: str, cfg, cell: dict, ranks: list[dict], steps: int) -> None:
    for r in ranks:
        want = _par_expected(cfg, cell, r["coords"]["stage"], steps)
        if r["launches"] != want:
            raise AssertionError(f"{tag} rank {r['coords']}: launches {r['launches']} "
                                 f"!= {want}")


def _pipe_table(session):
    from repro_torch.core.dpp.executor import build_time_table
    from repro_torch.parallel.plan import forward_order

    plan = session.parallel_plan()
    return plan, build_time_table(forward_order(plan), plan.pp, plan.n_chunks,
                                  plan.n_micro_local)


def _pipe_kwargs(cfg, plan, table, dev) -> dict:
    """``pipeline_loss``'s keyword arguments for ``plan`` on ``dev``."""
    from repro_torch.core.dpp.executor import make_pipeline_stages
    from repro_torch.models import pipeline as pl

    return dict(layout=pl.pipeline_layout(cfg, plan.pp, plan.n_chunks), table=table,
                stages=make_pipeline_stages(plan.pp, dev), n_micro=plan.n_micro)


def _plan_of(argv: list[str]):
    """The ``ParallelPlan`` a command line resolves to (MegaDPP's planner for
    ``wave``), without running it."""
    from repro_torch.app.cli import parse
    from repro_torch.app.session import Session

    _, rc = parse(argv)
    return Session(rc).parallel_plan()


def _median_ms(history: list[dict], skip: int = 1) -> float:
    return 1e3 * statistics.median(h["step_s"] for h in history[skip:])


def _check_losses(tag: str, history: list[dict]) -> None:
    for h in history:
        log(f"[{tag}] step {h['step']} loss={h['loss']:.4f} lr={h['lr']:.3e} "
            f"grad_norm={h['grad_norm']:.4f} step_ms={1e3 * h['step_s']:.1f}")
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag} losses not finite and falling: {losses}")


def pipeline_phase(torch, dev, smi: str, tag: str = "pipeline", also: tuple = ()) -> list:
    """MegaDPP on the card, each stage a process: the runs of (1), (3), (4)
    and (5) share one world of two ranks spawned on the card (gloo), each
    through ``python -m repro_torch``'s ``Session``, with every rank's
    kernel launches counted.  (1) Full-width, full-depth qwen2-0.5b
    trained :data:`PIPE_STEPS` steps at pp 2, 2 chunks, 4 microbatches,
    the planner's wave (``--modules scan,metrics,dpp --trace-out``): each
    rank's K1 and K2 launches exact (:func:`_par_expected`), losses finite
    and falling, ``pp_F`` and ``pp_B`` events, 16 a step each, on stage
    pids 0 and 1, the ``dpp`` report's keys, ``results["parallel"]`` the
    plan's summary on its mesh; one pipelined step of one process under
    the profiler.  The world runs the jobs ``also`` after its own (the
    parallel phase's 2-rank cells, which share its start-up), and the
    phase returns their rows.  (2) The pipelined loss and gradients of one batch, one
    process, against the fused ones (:func:`step_check` at the step
    check's limits).  (3) MegaFBD attached: 2 steps with
    ``parallel.fbd_backward`` (each stage's backward on the other stage's
    process) and without, losses and every rank's updated master weights
    bit-identical; then ``make_decoupled_step`` over the pipelined loss in
    one process, its gradients bit-identical to ``torch.autograd.grad``'s,
    also with the residuals moved to host memory and back, ``fwd`` and
    ``bwd`` timed with CUDA events.  (4) rwkv6-3b at full width cut to
    :data:`PIPE_RWKV_LAYERS` layers through the pipeline: K5 and K1
    launched exactly on each rank, losses falling, the pipelined loss of
    one batch within ``RWKV_STEP_LOSS_TOL`` of the fused one.  (5) The
    four schedules and the fused step (one process) at the qwen2 shape,
    full depth: each table's T and bubble fraction, the median step and
    the peak memory per rank."""
    import collections

    from repro_torch.core.dpp.executor import bubble_fraction, build_time_table
    from repro_torch.core.fbd import make_decoupled_step
    from repro_torch.core.tracing import from_chrome
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.models import lm
    from repro_torch.models import pipeline as pl
    from repro_torch.parallel.plan import forward_order, plan_summary
    from repro_torch.train.optim import leaves
    from repro_torch.train.train_step import (
        compute_params, init_train_state, to_device_batch)

    kernels = ("flash_attention", "rmsnorm")
    out_dir = RUNTIME_DIR / "trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = get_config("qwen2-0.5b")
    cell = dict(pp=PIPE["pp"], n_micro=PIPE["n_micro"])
    shape = dict(TRAIN, steps=PIPE_STEPS)
    main_argv = [*_pipe_argv(shape, "wave", "scan,metrics,dpp"),
                 "--trace-out", str(out_dir / "pipeline.json")]
    fbd_argv = _pipe_argv(dict(TRAIN, steps=PIPE_FBD_STEPS), "wave", "none")
    rcfg = get_config("rwkv6-3b").replace(num_layers=PIPE_RWKV_LAYERS, remat="full")
    rwkv_argv = _pipe_argv(PIPE_RWKV, "1f1b", "none", arch="rwkv6-3b")
    sweep = dict(TRAIN, steps=PIPE_SWEEP_STEPS)
    sweep_argv = {s: _pipe_argv(sweep, s, "none") for s in PIPE_SCHEDULES}
    for argv in (main_argv, rwkv_argv, *sweep_argv.values()):
        log(f"[{tag}] python -m repro_torch {' '.join(argv)}")
    jobs = [dict(argv=main_argv, kernels=kernels),
            dict(argv=fbd_argv, kernels=kernels, keep=True),
            dict(argv=[*fbd_argv, "--set", "parallel.fbd_backward=true"],
                 kernels=kernels, compare=True),
            dict(argv=rwkv_argv, kernels=("wkv6", "rmsnorm"), model_cfg=rcfg),
            *(dict(argv=a, kernels=kernels) for a in sweep_argv.values())]
    runs = _world([*jobs, *also], PIPE["pp"], tag)
    main_run, fbd_off, fbd_on, rwkv_run, *sweep_runs = runs[:len(jobs)]

    # (1) qwen2-0.5b through the Session, a stage a process
    history = main_run[0]["history"]
    plan = _plan_of(main_argv)
    table = build_time_table(forward_order(plan), plan.pp, plan.n_chunks,
                             plan.n_micro_local)
    data, ocfg = _train_setup(cfg, shape)
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers in {plan.pp} stages x "
        f"{plan.n_chunks} chunks ({cfg.num_layers // (plan.pp * plan.n_chunks)} a cell), "
        f"{plan.n_micro} microbatches of {data.global_batch // plan.n_micro} rows, "
        f"schedule {plan.schedule} wave {plan.wave}: T={table.steps}, bubble fraction "
        f"{bubble_fraction(table)!r}; launches per rank "
        + "; ".join(f"{r['coords']}: {r['launches']}" for r in main_run)
        + f"; peak per rank {[r['peak'] for r in main_run]} B")
    _check_losses(tag, history)
    _check_world_launches(tag, cfg, cell, main_run, PIPE_STEPS)
    step_ms = _median_ms(history)
    log(f"[{tag}] median step (steps 2-{PIPE_STEPS}) {step_ms:.1f} ms, "
        f"{data.seq_len * data.global_batch / step_ms * 1e3:.1f} tokens/s; first step "
        f"{1e3 * history[0]['step_s']:.1f} ms ({smi})")
    state = init_train_state(cfg, seed=0, device=dev)
    profile_train_step(torch, cfg, ocfg, data, state, f"{tag}-one-process",
                       step_ms / 1e3, plan=plan)
    del state
    _free(torch)
    events = from_chrome(json.loads((out_dir / "pipeline.json").read_text()))
    per_step = plan.n_micro * plan.n_chunks * plan.pp
    for name in ("pp_F", "pp_B"):
        evs = [e for e in events if e.name == name]
        by_step = collections.Counter(e.args["step"] for e in evs)
        pids = sorted({e.rank for e in evs})
        log(f"[{tag}] {name} events a step {dict(by_step)}, stage pids {pids}")
        if by_step != {s: per_step for s in range(PIPE_STEPS)} or pids != [0, 1]:
            raise AssertionError(f"{tag}: {name} events {dict(by_step)} on pids {pids}")
    res = main_run[0]["results"]
    want = {**plan_summary(plan), "stages": [0, 1],
            "mesh": {"stage": plan.pp, "data": 1, "model": 1},
            "coords": {"stage": 0, "data": 0, "model": 0}, "backend": "gloo"}
    log(f"[{tag}] dpp report {res['dpp']}; parallel {res['parallel']}")
    if res["parallel"] != want:
        raise AssertionError(f"{tag}: results['parallel'] {res['parallel']} != {want}")
    if set(res["dpp"]) != {"schedule", "wave", "makespan_ms", "peak_memory_mib",
                           "step_ms_p50", "step_ms_max"}:
        raise AssertionError(f"{tag}: the dpp report's keys {sorted(res['dpp'])}")
    pipe_kw = _pipe_kwargs(cfg, plan, table, dev)

    # (2) the pipelined loss and gradients against the fused ones
    step_check(torch, dev, cfg, data, mixer="attn", tag=f"{tag}-step",
               batch_step=PIPE_STEPS,
               tols=(STEP_LOSS_TOL, STEP_GNORM_RTOL, STEP_LEAF_RTOL), pipeline=pipe_kw)

    # (3) MegaFBD's decoupled backward attached to the pipelined step
    losses_f = [h["loss"] for h in fbd_off[0]["history"]]
    losses_d = [h["loss"] for h in fbd_on[0]["history"]]
    bad = sorted({k for r in fbd_on for k in r["differing"]})
    n_leaves = len(fbd_on[0]["digest"])
    log(f"[{tag}-fbd] {PIPE_FBD_STEPS} steps, a stage a process: without MegaFBD "
        f"{losses_f!r}, with it {losses_d!r}; master leaves differing on a rank "
        f"{bad or 'none'} of {n_leaves}; launches per rank without "
        + "; ".join(str(r["launches"]) for r in fbd_off) + ", with "
        + "; ".join(str(r["launches"]) for r in fbd_on))
    if losses_f != losses_d or bad:
        raise AssertionError(f"{tag}-fbd: the decoupled pipelined steps differ from the fused")
    _check_world_launches(f"{tag}-fbd", cfg, cell, fbd_off, PIPE_FBD_STEPS)
    _check_world_launches(f"{tag}-fbd", cfg, dict(cell, fbd=True), fbd_on, PIPE_FBD_STEPS)
    params = compute_params(lm.init(cfg, seed=0, device=dev), torch.bfloat16)
    batch = to_device_batch(SyntheticTokens(data).batch_at(0), dev)
    flat = [p for _, p in leaves(params)]
    loss_fn = lambda p, b: pl.pipeline_loss(cfg, p, b, **pipe_kw)[0]  # noqa: E731
    ref_loss = loss_fn(params, batch)
    ref = torch.autograd.grad(ref_loss, flat)
    ref_loss = ref_loss.detach()
    decoupled = make_decoupled_step(loss_fn)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for host in (False, True):
        ev[0].record()
        loss, res_ = decoupled.fwd(params, batch)
        ev[1].record()
        moved = 0.0
        if host:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res_.to("cpu")
            res_.to(dev)
            torch.cuda.synchronize()
            moved = time.perf_counter() - t0
        ev[2].record()
        nbytes = res_.nbytes
        grads = decoupled.bwd(params, batch, res_, torch.ones_like(loss))
        ev[3].record()
        torch.cuda.synchronize()
        bad = [".".join(p) for (p, g), r in zip(leaves(grads), ref) if not torch.equal(g, r)]
        bad += [] if torch.equal(loss, ref_loss) else ["loss"]
        del grads, res_
        log(f"[{tag}-fbd] decoupled pipelined loss, one process"
            f"{', after the host round trip' if host else ''}: "
            f"fwd {ev[0].elapsed_time(ev[1]):.2f} ms, bwd {ev[2].elapsed_time(ev[3]):.2f} ms "
            f"(CUDA events; {smi}); residual_bytes {nbytes}; round trip "
            f"{1e3 * moved:.1f} ms; leaves differing from autograd.grad {bad or 'none'} "
            f"of {len(ref)}")
        if bad:
            raise AssertionError(f"{tag}-fbd: decoupled gradients differ: {bad}")
    del params, flat, ref
    _free(torch)

    # (4) rwkv6-3b through the pipeline
    rdata, _ = _train_setup(rcfg, PIPE_RWKV)
    rplan = _plan_of(rwkv_argv)
    rtable = build_time_table(forward_order(rplan), rplan.pp, rplan.n_chunks,
                              rplan.n_micro_local)
    log(f"[{tag}-rwkv] depth cut to {PIPE_RWKV_LAYERS} layers; launches per rank "
        + "; ".join(f"{r['coords']}: {r['launches']}" for r in rwkv_run))
    _check_losses(f"{tag}-rwkv", rwkv_run[0]["history"])
    _check_world_launches(f"{tag}-rwkv", rcfg, dict(pp=rplan.pp, n_micro=rplan.n_micro),
                          rwkv_run, PIPE_RWKV["steps"])
    params = compute_params(lm.init(rcfg, seed=0, device=dev), torch.bfloat16)
    batch = to_device_batch(SyntheticTokens(rdata).batch_at(PIPE_RWKV["steps"]), dev)
    with torch.no_grad():
        fused = lm.loss_fn(rcfg, params, batch)[0].item()
        piped = pl.pipeline_loss(rcfg, params, batch,
                                 **_pipe_kwargs(rcfg, rplan, rtable, dev))[0].item()
    del params
    _free(torch)
    log(f"[{tag}-rwkv] one batch: pipelined loss {piped!r}, fused {fused!r}, "
        f"|dloss|={abs(piped - fused):.2e} (tol {RWKV_STEP_LOSS_TOL})")
    if not abs(piped - fused) <= RWKV_STEP_LOSS_TOL:
        raise AssertionError(f"{tag}-rwkv: pipelined loss {piped} vs fused {fused}")

    # (5) the four schedules, a stage a process, and the fused step
    for m in (flash_attention, rmsnorm):
        m.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    _, (state, history) = _session([*_train_argv(sweep), "--modules", "none"])
    torch.cuda.synchronize()
    counts = {**flash_attention.launches, **rmsnorm.launches}
    del state
    _free(torch)
    ms = [1e3 * h["step_s"] for h in history[1:]]
    log(f"[{tag}-schedules] fused step (one process, no pipeline); median step (steps "
        f"2-{PIPE_SWEEP_STEPS}) {statistics.median(ms):.1f} ms ({min(ms):.1f}-"
        f"{max(ms):.1f}); max_memory_allocated={torch.cuda.max_memory_allocated()}; "
        f"launches {counts} ({smi})")
    if counts != {k: PIPE_SWEEP_STEPS * v for k, v in per_step_launches(cfg).items()}:
        raise AssertionError(f"{tag}-schedules fused: launches {counts}")
    for (name, argv), ranks in zip(sweep_argv.items(), sweep_runs):
        splan = _plan_of(argv)
        stable = build_time_table(forward_order(splan), splan.pp, splan.n_chunks,
                                  splan.n_micro_local)
        ms = [1e3 * h["step_s"] for h in ranks[0]["history"][1:]]
        log(f"[{tag}-schedules] schedule {name} (wave {splan.wave}), a stage a process: "
            f"T={stable.steps}, bubble fraction {bubble_fraction(stable)!r}; median step "
            f"(steps 2-{PIPE_SWEEP_STEPS}) {statistics.median(ms):.1f} ms ({min(ms):.1f}-"
            f"{max(ms):.1f}); max_memory_allocated per rank {[r['peak'] for r in ranks]}; "
            f"launches per rank {[r['launches'] for r in ranks]} ({smi})")
        _check_world_launches(f"{tag}-schedules {name}", cfg, cell, ranks, PIPE_SWEEP_STEPS)
    return runs[len(jobs):]


# -------------------------------------------------------------------- main


# ------------------------------- data, tensor and stage parallelism (item 8b)

# qwen2-0.5b at full width and all 24 layers in worlds of ranks spawned on
# the one card (gloo: the ranks share it), 3 steps at seq 2048 (past
# attn_kv_chunk: K2 runs) from the parameters of seed 0: dp 2 and tp 2 at
# batch 2, the pipelines at batch 4 in 4 microbatches of a row (two a dp
# group in pp 2 x dp 2), so that 1f1b reaches its steady state
PAR_SHAPE = dict(seq_len=2048, global_batch=2, steps=3, seed=0)
PAR_PIPE_BATCH = 4
PAR_CELLS = (
    ("dp2", dict(dp=2), ["--set", "parallel.dp=2"]),
    ("tp2", dict(tp=2), ["--set", "parallel.tp=2"]),
    ("pp2-fbd", dict(pp=2, n_micro=4, fbd=True),
     ["--pp", "2", "--pp-schedule", "1f1b", "--n-micro", "4",
      "--set", "parallel.fbd_backward=true"]),
    ("pp2-dp2", dict(pp=2, dp=2, n_micro=4),
     ["--pp", "2", "--pp-schedule", "1f1b", "--n-micro", "4", "--set", "parallel.dp=2"]),
)


def _par_shape(cell: dict) -> dict:
    return (dict(PAR_SHAPE, global_batch=PAR_PIPE_BATCH) if cell.get("pp", 1) > 1
            else PAR_SHAPE)


class _StepRecorder:
    """On a rank of a world: the time of the world's all-reduces (between two
    synchronisations of the card, which the tensor split's many small ones
    slow a little), and each step's per-layer leaf gradient norms, squared
    (:func:`_leaf_norms`' leaves, at AdamW's entry, after the sums over the
    data ranks), of this rank's part.  With ``check``, each step's
    reference: before the step every rank sends rank 0 its part of the
    compute-dtype parameters (the step info's ``gather``), rank 0 takes the
    fused one-process loss and gradients of the step's whole batch from
    them through the kernels (their launches kept out of the counts), and
    the ranks meet at a barrier; ``check_s`` is the time that took on this
    rank, inside the step's time, and ``peak`` the rank's peak memory over
    its steps, the reference's left out.  With ``first``, the rank's first step
    runs under Python's profiler (``first_profile``: the 10 functions that
    took the most time of their own, and the 10 that took the most in all)."""

    def __init__(self, check: bool = False, first: bool = False):
        self.check, self.first = check, first

    def __enter__(self):
        import torch
        import torch.distributed as dist

        from repro_torch.kernels import flash_attention, rmsnorm
        from repro_torch.models.model import get_model
        from repro_torch.parallel import dist as pdist
        from repro_torch.train import loop
        from repro_torch.train import train_step as ts

        self.norms, self.refs, self.check_s, self.sync_s, self.peak = [], [], [], 0.0, 0
        self.losses = []  # with check: each step's own loss, beside its reference
        self.first_profile = None if self.first else ""
        self._undo = []

        def adamw(ocfg, grads, *a, _real=ts.adamw_update, **kw):
            self.norms.append({k: v.double().square().cpu()
                               for k, v in _leaf_norms(grads, "attn").items()})
            return _real(ocfg, grads, *a, **kw)

        def timed(fn):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.sync_s += time.perf_counter() - t0
                return out
            return call

        def reference(cfg, params: dict, batch: dict, tp: int) -> tuple:
            saved = [(m, dict(m.launches)) for m in (flash_attention, rmsnorm)]
            params = ts.tree_map(lambda t: t.detach().requires_grad_(True), params)
            dev = next(iter(ts.leaves(params)))[1].device
            batch = ts.to_device_batch(batch, dev)
            out = []
            for run in ("kernels",) + (("plain", "split") if tp > 1 else ()):
                if run == "split":
                    loss = _split_loss(torch, cfg, params, batch, tp)
                else:
                    loss, _ = get_model(cfg).loss_fn(cfg, params, batch,
                                                     plain=run == "plain")
                grads = ts.grad_tree(params, loss, ts.unused_leaves(cfg))
                out.append((loss.item(), ts.global_norm(grads).item(),
                            {k: v.cpu() for k, v in _leaf_norms(grads, "attn").items()}))
                del loss, grads
            for m, counts in saved:
                m.launches.update(counts)
            return tuple(out)

        def make(cfg, *a, _real=loop.make_train_step, **kw):
            step = _real(cfg, *a, **kw)

            def checked(state, *rest):  # (batch) or, compressed, (err, batch)
                batch = rest[-1]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if self.check:
                    whole = step.parallel.gather(state.params)
                    if whole is not None:
                        self.refs.append(reference(cfg, whole, batch,
                                                   step.parallel.plan.tp))
                    del whole
                    dist.barrier()
                    # the rank's own peak, without the reference's
                    torch.cuda.reset_peak_memory_stats()
                self.check_s.append(time.perf_counter() - t0)
                if self.first_profile is not None:
                    out = step(state, *rest)
                else:  # a new rank's first step, under the Python profiler
                    prof = cProfile.Profile()
                    out = prof.runcall(step, state, *rest)
                    torch.cuda.synchronize()
                    text = io.StringIO()
                    for key in ("tottime", "cumulative"):
                        pstats.Stats(prof, stream=text).sort_stats(key).print_stats(10)
                    self.first_profile = text.getvalue()
                if self.check:
                    self.losses.append(float(out[-1]["loss"]))
                self.peak = max(self.peak, torch.cuda.max_memory_allocated())
                return out

            checked.parallel = step.parallel
            checked.pipeline = getattr(step, "pipeline", None)
            return checked

        patches = [(ts, "adamw_update", adamw),
                   *((pdist, n, timed(getattr(pdist, n))) for n in
                     ("all_reduce_tree", "all_reduce_scalar", "_all_reduce_f32"))]
        patches.append((loop, "make_train_step", make))
        for mod, name, new in patches:
            self._undo.append((mod, name, getattr(mod, name)))
            setattr(mod, name, new)
        return self

    def __exit__(self, *exc):
        for mod, name, old in self._undo:
            setattr(mod, name, old)


def _split_loss(torch, cfg, params: dict, batch: dict, tp: int) -> "torch.Tensor":
    """The loss of ``cfg`` (dense GQA blocks) with Megatron's tensor split
    over ``tp`` ranks done in one process, as ``models.pipeline``'s tp block
    sums it: each block's attention and MLP run once per tensor slice of
    their weights (the slices ``weights.shard_params`` gives tensor rank
    ``t``), their float32 output products summed over the slices and
    rounded once; each slice reads the norm's output through a view of its
    own, so its input gradient sums within the slice first, as on its
    rank.  The fused step's arithmetic with the tensor split's order of
    sums: what a tp run should reproduce."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.pipeline import _tp_local_cfg, head_loss, pipeline_layout, tp_slices
    from repro_torch.train.optim import tree_map

    layout = pipeline_layout(cfg, 1, 1, tp=tp)
    dims = {path[2:]: d - 1 for path, d in tp_slices(lm.param_axes(cfg), layout).items()}
    local = _tp_local_cfg(cfg, tp)
    x = L.embed_apply(params, cfg, batch["tokens"], getattr(torch, cfg.compute_dtype))
    positions = L.arange_positions(x.shape[1], x.device)

    def part(p: dict, sub: str, t: int) -> dict:
        return {k: v.chunk(tp, dims[(sub, k)])[t].contiguous() if (sub, k) in dims else v
                for k, v in p[sub].items()}

    for i in range(cfg.num_layers):
        bp = tree_map(lambda a: a[i], params[layout.seg_key])["b0"]
        h = L.norm_apply(bp["ln1"], x, cfg.norm_kind, cfg.norm_eps)
        a = sum(L.gqa_apply(part(bp, "attn", t), local, h.view_as(h), positions=positions,
                            out_float32=True) for t in range(tp))
        x = lm._resid(cfg, x, a.to(x.dtype))
        h = L.norm_apply(bp["ln2"], x, cfg.norm_kind, cfg.norm_eps)
        f = sum(L.mlp_apply(part(bp, "mlp", t), local, h.view_as(h), out_float32=True)
                for t in range(tp))
        x = lm._resid(cfg, x, f.to(x.dtype))
    return head_loss(cfg, params, x, batch)[0]


def _whole_norms(torch, cfg, cell: dict, ranks: list[dict], k: int) -> dict:
    """Step ``k``'s per-layer leaf gradient norms of the whole model from
    the squared norms of the ranks' parts: the ranks of data 0; a stage's
    rows of a layer-stacked leaf at its cells' layers; a tensor-sliced leaf
    summed over the tensor ranks, any other from tensor rank 0."""
    from repro_torch.models import lm
    from repro_torch.models.pipeline import pipeline_layout, tp_slices

    pp, tp = cell.get("pp", 1), cell.get("tp", 1)
    layout = pipeline_layout(cfg, pp, 1, tp=tp)
    sliced = {".".join(p) for p in tp_slices(lm.param_axes(cfg), layout)} if tp > 1 else set()
    g = layout.groups_per_cell
    sq: dict = {}
    for r in ranks:
        at = r["coords"]
        if at["data"]:
            continue
        for key, v in r["norms"][k].items():
            if at["model"] and key not in sliced:
                continue
            if pp > 1 and key.startswith("seg"):
                whole = sq.setdefault(key, torch.zeros(layout.n_groups, dtype=torch.float64))
                rows = [(c * pp + at["stage"]) * g + j
                        for c in range(layout.n_chunks) for j in range(g)]
                whole[rows] += v
            else:
                sq[key] = sq[key] + v if key in sq else v.clone()
    return {key: v.sqrt() for key, v in sq.items()}


def _size(cell: dict) -> int:
    return cell.get("pp", 1) * cell.get("dp", 1) * cell.get("tp", 1)


def _parallel_jobs() -> dict[int, list]:
    """``{world size: [(name, cell, job)]}`` of :data:`PAR_CELLS`, the jobs
    :func:`_world_rank` runs, each step checked."""
    out: dict[int, list] = {}
    for name, cell, extra in PAR_CELLS:
        job = dict(argv=[*_train_argv(_par_shape(cell)), "--modules", "none", *extra],
                   kernels=("flash_attention", "rmsnorm"), check=True)
        out.setdefault(_size(cell), []).append((name, cell, job))
    return dict(sorted(out.items()))


def parallel_phase(torch, smi: str, tag: str = "parallel", done: dict | None = None) -> None:
    """Data, tensor and stage parallelism through ``python -m repro_torch``'s
    own entry point, each cell's ranks spawned on the one card: (a) dp 2,
    (b) tp 2 (K2 at H 7, K 1 a rank), (c) pp 2 with each stage a process,
    1f1b, MegaFBD's backward on the other stage's process, (d) pp 2 x dp
    2.  Every step is held at the qwen2 step limits to the fused
    one-process step from the same parameters (:class:`_StepRecorder`'s
    reference): loss, gradient norm and per-layer leaf gradient norms.
    Each rank's K1 and K2 launches must be exact, and ranks that hold the
    same part of the model (data replicas) must end with the same master
    weights.  Logs the backend, each cell's step median beside the fused
    step's at its batch (a fused run of one process through the
    ``Session``, whose trajectory the cell's is logged against) and the
    share of its steps spent in all-reduces.  ``done``: ``{world size: the
    rows of its cells}`` of worlds already run (:func:`pipeline_phase`'s
    world runs the 2-rank cells)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, rmsnorm

    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"[{tag}] {smi}; compute mode {mode}; ranks spawned on cuda:0 share it")
    cfg = get_config("qwen2-0.5b")
    steps = PAR_SHAPE["steps"]
    done = done or {}
    fused = {}
    for batch in sorted({_par_shape(c)["global_batch"] for _, c, _ in PAR_CELLS}):
        _free(torch)
        for m in (flash_attention, rmsnorm):
            m.reset_launches()
        argv = [*_train_argv(dict(PAR_SHAPE, global_batch=batch)), "--modules", "none"]
        _, (state, hist) = _session(argv)
        torch.cuda.synchronize()
        del state
        _free(torch)
        counts = {**flash_attention.launches, **rmsnorm.launches}
        if counts != _par_expected(cfg, {}, 0, steps):
            raise AssertionError(f"{tag} fused launches {counts}")
        fused[batch] = hist
        log(f"[{tag}] fused (one process) at batch {batch}: losses "
            + " ".join(f"{h['loss']:.5f}" for h in hist)
            + " grad_norms " + " ".join(f"{h['grad_norm']:.5f}" for h in hist)
            + f"; step median {_median_ms(hist):.1f} ms")
    runs = {}
    for world, cells in _parallel_jobs().items():
        for n, _, job in cells:
            log(f"[{tag}] {n}: python -m repro_torch {' '.join(job['argv'])}")
        rows = done[world] if world in done else _world([j for _, _, j in cells], world, tag)
        for (n, _, _), ranks in zip(cells, rows):
            runs[n] = ranks
    loss_tol, gnorm_rtol, leaf_rtol = STEP_LOSS_TOL, STEP_GNORM_RTOL, STEP_LEAF_RTOL
    for name, cell, _ in PAR_CELLS:
        ranks = runs[name]
        hist, refs = ranks[0]["history"], ranks[0]["refs"]
        backends = {r["backend"] for r in ranks}
        if backends != {"gloo"}:
            raise AssertionError(f"{tag} {name}: backends {backends}, the rule says gloo")
        _check_world_launches(f"{tag} {name}", cfg, cell, ranks, steps)
        if len(refs) != steps or any(len(r["norms"]) != steps for r in ranks):
            raise AssertionError(f"{tag} {name}: {len(refs)} references for {steps} steps")
        ok = all(math.isfinite(h["loss"]) for h in hist)
        def gaps(a, b):
            (la, ga, na), (lb, gb, nb) = a, b
            d = {n: ((na[n] - v).abs() / v).max().item() for n, v in nb.items()}
            worst = max(d, key=d.get)
            return abs(la - lb), abs(ga - gb) / gb, worst, d[worst]

        def held(what: str, got: tuple, ref: tuple) -> bool:
            d_loss, d_gn, worst, d_worst = gaps(got, ref)
            good = d_loss <= loss_tol and d_gn <= gnorm_rtol and d_worst <= leaf_rtol
            log(f"[{tag}] {name} step {k + 1}, {what}: |dloss|={d_loss:.2e} (tol "
                f"{loss_tol}) rel dgrad_norm={d_gn:.2e} (tol {gnorm_rtol}) largest leaf "
                f"{worst}={d_worst:.2e} (tol {leaf_rtol}) {'ok' if good else 'FAIL'}")
            return good

        for k, (h, (ref_k, *tp_refs)) in enumerate(zip(hist, refs)):
            norms = _whole_norms(torch, cfg, cell, ranks, k)
            if set(norms) != set(ref_k[2]):
                raise AssertionError(f"{tag} {name}: leaves {sorted(norms)} != "
                                     f"{sorted(ref_k[2])}")
            got = (h["loss"], h["grad_norm"], norms)
            log(f"[{tag}] {name} step {k + 1}: loss {h['loss']:.5f}, the fused kernel "
                f"step's from the same parameters {ref_k[0]:.5f}")
            if tp_refs:
                # tp: held to the fused step with the split's order of sums
                # at every step, to the unsplit one at the first (the
                # parameters every run starts from); later steps' gaps to
                # the unsplit one logged beside the fused plain step's, a
                # change of rounding of the same size
                ref_p, split = tp_refs
                c_loss, c_gn, c_worst, c_d = gaps(ref_p, ref_k)
                log(f"[{tag}] {name} step {k + 1}, the fused plain step against the "
                    f"fused kernel step (logged): |dloss|={c_loss:.2e} rel dgrad_norm="
                    f"{c_gn:.2e} largest leaf {c_worst}={c_d:.2e}")
                ok = held("against the fused kernel step with the tensor split's "
                          "sums (one process)", got, split) and ok
                if k == 0:
                    ok = held("against the fused kernel step", got, ref_k) and ok
                else:
                    d_loss, d_gn, worst, d_worst = gaps(got, ref_k)
                    log(f"[{tag}] {name} step {k + 1}, against the fused kernel step "
                        f"(logged): |dloss|={d_loss:.2e} rel dgrad_norm={d_gn:.2e} largest "
                        f"leaf {worst}={d_worst:.2e}")
            else:
                ok = held("against the fused kernel step", got, ref_k) and ok
        replicas: dict = {}
        for r in ranks:
            replicas.setdefault((r["coords"]["stage"], r["coords"]["model"]), []).append(
                r["digest"])
        apart = [k for k, ds in replicas.items() if any(d != ds[0] for d in ds[1:])]
        ok = ok and not apart
        ref = fused[_par_shape(cell)["global_batch"]]
        step_ms = [1e3 * (h["step_s"] - c) for h, c in zip(hist, ranks[0]["check_s"])]
        busy = sum(step_ms) / 1e3
        log(f"[{tag}] {name}: {_size(cell)} ranks, backend gloo; data replicas "
            f"{'apart at ' + str(apart) if apart else 'agree'}; against the fused "
            "run's trajectory (parameters that moved apart after step 1) |dloss| "
            + " ".join(f"{abs(a['loss'] - b['loss']):.2e}" for a, b in zip(hist, ref)))
        log(f"[{tag}] {name}: step median {statistics.median(step_ms[1:]):.1f} ms (fused "
            f"{_median_ms(ref):.1f} ms at batch {_par_shape(cell)['global_batch']}), "
            "steps " + " ".join(f"{t:.1f}" for t in step_ms)
            + f" ms (the reference's {1e3 * sum(ranks[0]['check_s']):.1f} ms taken out); "
            f"rank 0 all-reduce share {ranks[0]['sync_s'] / busy:.3f} "
            f"({1e3 * ranks[0]['sync_s']:.1f} of {1e3 * busy:.1f} ms); launches per rank "
            + "; ".join(f"{r['coords']}: {r['launches']}" for r in ranks)
            + f"; peak per rank {[r['peak'] for r in ranks]} B")
        if not ok:
            raise AssertionError(f"{tag} {name}: the parallel step disagrees with the fused one")


# --------------------------------------------- phase 11: the dryrun on meta

DRYRUN_DIR = RUNTIME_DIR / "dryrun"
PEAK_RTOL = 0.10                       # peak_est_bytes against the card's peak
DRYRUN_TRAIN = dict(seq_len=2048, global_batch=8)


def start_dryrun_all():
    """``python -m repro_torch dryrun --all`` over the full configs, on the
    meta device (the CPU: nothing reaches the card), started in the
    background at a lower priority (``nice`` 19) when the training phases
    begin, and read by :func:`dryrun_phase`; stopped at exit if still
    running."""
    import atexit
    import shutil

    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    out = open(DRYRUN_DIR / "stdout.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "dryrun", "--all", "--out", str(DRYRUN_DIR)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO / "src")), stdout=out,
        stderr=subprocess.STDOUT, text=True)
    os.setpriority(os.PRIO_PROCESS, proc.pid, 19)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()

    atexit.register(stop)
    return proc, time.perf_counter(), stop


def dryrun_peak(torch, dev, cfg, shape: dict, tag: str, smi: str, *, base: int,
                peak: int, est: dict) -> None:
    """``est``'s ``peak_est_bytes`` (the cell on the meta device) against
    ``peak - base``, the card's ``max_memory_allocated`` over a real step of
    the same cell above what was allocated before its state: within
    :data:`PEAK_RTOL`."""
    got = peak - base
    mem = est["memory"]
    ratio = mem["peak_est_bytes"] / got
    log(f"[{tag}] {cfg.name} ({cfg.num_layers} layers, remat {cfg.remat}) at "
        f"{shape['seq_len']} x {shape['global_batch']}: peak_est_bytes "
        f"{mem['peak_est_bytes']} (arguments {mem['argument_bytes']}, temp "
        f"{mem['temp_bytes']}, output {mem['output_bytes']}, alias {mem['alias_bytes']}; "
        f"estimated in {est['estimate_s']:.1f} s on the meta device) against "
        f"max_memory_allocated over a real step {got}: ratio {ratio:.4f} ({smi})")
    if abs(ratio - 1) > PEAK_RTOL:
        raise AssertionError(f"{tag}: peak_est_bytes {mem['peak_est_bytes']} is not "
                             f"within {PEAK_RTOL:.0%} of the card's {got}")


def dryrun_phase(torch, dev, smi: str, background, tag: str = "dryrun") -> None:
    """The dryrun on the card's side.  (a) The wrappers' meta-device sizes
    (K2's backward scratch, K3's split scratch, K5's chunk) equal their
    libraries'.  (b) qwen2-0.5b at full width and depth, remat full, 2048 x
    8: ``peak_est_bytes`` of its cell within :data:`PEAK_RTOL` of the
    card's peak over one real step from the same state; the cell's flops,
    the train loop's meta count and a real pass's count on the card one
    integer.  (c) ``dryrun --all`` (started in the background by
    :func:`start_dryrun_all`): a line a cell with its seconds, each cell a
    number (flops and a peak) or a reasoned ``FAIL``."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import ops as k2
    from repro_torch.kernels.paged_attention import ops as k34
    from repro_torch.kernels.wkv6 import ops as k5
    from repro_torch.launch.dryrun import all_cells, estimate
    from repro_torch.launch.specs import input_specs
    from repro_torch.models.model import make_batch
    from repro_torch.train.loop import step_flops
    from repro_torch.train.optim import OptimizerConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    sizes = {
        "flash_bwd scratch floats at B 8, S 2048, H 14": (
            k2.meta_scratch_floats(8, 2048, 14), k2._scratch_floats(8, 2048, 14)),
        "paged_decode scratch bytes at 8 slots, Q 5, H 14, K 2, dh 64, M 128": (
            k34.meta_scratch_bytes(8, 5, 14, 2, 64, BS, 128),
            k34._c_size("paged_decode", "paged_decode_scratch_bytes", 7)(
                8, 5, 14, 2, 64, BS, 128)),
        "wkv6 chunk": (k5.META_CHUNK, k5._c_fn("wkv6_fwd", "wkv6_fwd_chunk", [],
                                                 __import__("ctypes").c_int)()),
    }
    log(f"[{tag}] meta sizes against the libraries: " + "; ".join(
        f"{k} {a} / {b}" for k, (a, b) in sizes.items()))
    if any(a != b for a, b in sizes.values()):
        raise AssertionError(f"{tag}: a meta-device size differs from its library's")

    cfg = get_config("qwen2-0.5b").replace(remat="full")
    shape = ShapeConfig("train_2048x8", DRYRUN_TRAIN["seq_len"],
                        DRYRUN_TRAIN["global_batch"], "train")
    est = estimate(input_specs(cfg, shape))
    _free(torch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = init_train_state(cfg, seed=0, device=dev)
    batch = make_batch(cfg, shape.global_batch, shape.seq_len, np.random.default_rng(0),
                       device=dev)
    step = make_train_step(cfg, OptimizerConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, met = step(state, batch)
    float(met["loss"])
    torch.cuda.synchronize()
    dryrun_peak(torch, dev, cfg, DRYRUN_TRAIN, tag, smi, base=base,
                peak=torch.cuda.max_memory_allocated(), est=est)
    meta, real = step_flops(cfg, state, batch), step_flops(cfg, state, batch, meta=False)
    log(f"[{tag}] flops a step: the cell's {est['flops']}, the loop's count on the meta "
        f"device {int(meta)}, a real pass on the card {int(real)}")
    if not est["flops"] == meta == real > 0:
        raise AssertionError(f"{tag}: flop counts differ: {est['flops']}, {meta}, {real}")
    del state, batch, met, step
    _free(torch)

    proc, t0, stop = background
    try:
        proc.wait(timeout=max(60.0, 900 - (time.perf_counter() - t0)))
    finally:
        stop()
    lines = (DRYRUN_DIR / "stdout.txt").read_text().splitlines()
    cells = [f"{a}__{s}__pod1" for a, s in all_cells()]
    log(f"[{tag}] python -m repro_torch dryrun --all: exit {proc.returncode} after "
        f"{time.perf_counter() - t0:.1f} s in the background, {len(cells)} cells")
    for ln in lines:
        if ln.startswith(("OK", "FAIL")):
            log(f"[{tag}] {ln}")
    for cell in cells:
        ok = [ln for ln in lines if ln.startswith(f"OK   {cell}:")]
        fail = [ln for ln in lines if ln.startswith(f"FAIL {cell}:")]
        if ok:
            res = json.loads((DRYRUN_DIR / f"{cell}.json").read_text())
            if not (res["flops"] > 0 and res["memory"]["peak_est_bytes"] > 0
                    and res["model_flops"] > 0):
                raise AssertionError(f"{tag}: {cell} has no estimate: {res}")
        elif not fail or len(fail[0].split(": ", 1)[1]) < 10:
            raise AssertionError(f"{tag}: {cell} has neither a number nor a reasoned "
                                 "FAIL")


def main() -> int:
    # where the environment turns bytecode caches off (PYTHONDONTWRITEBYTECODE),
    # every spawned rank would compile its imports from source again: keep
    # this run's compiled bytecode under build/pycache, where the ranks find
    # what this process imported
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = str(REPO / "build" / "pycache")
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, rglru, rmsnorm, wkv6
    from repro_torch.kernels.flash_attention.ops import shared_memory_bytes as flash_smem
    from repro_torch.models import griffin as griffin_model
    from repro_torch.models import rwkv as rwkv_model
    from repro_torch.kernels.paged_attention.ops import shared_memory_bytes
    from repro_torch.kernels.wkv6.ops import shared_memory_bytes as wkv6_smem
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
        if name == "paged_decode":
            smem, at = (f"{shared_memory_bytes(name, H=H, K=K, dh=DH)} / "
                        f"{shared_memory_bytes(name, H=GRIFFIN_H, K=1, dh=GRIFFIN_DH)}",
                        f"H={H} K={K} dh={DH} / H={GRIFFIN_H} K=1 dh={GRIFFIN_DH}, Q=1")
        elif name.startswith("paged"):
            smem, at = (shared_memory_bytes(name, H=H, K=K, dh=DH),
                        f"H={H} K={K} dh={DH} Q=1")
        elif name.startswith("flash"):
            smem, at = (f"{flash_smem(name, DH)} / {flash_smem(name, GRIFFIN_DH)} / "
                        f"{flash_smem(name, MLA_HEADS[2], MLA_HEADS[3])}",
                        f"dh={DH} / {GRIFFIN_DH} / {MLA_HEADS[2]} (v {MLA_HEADS[3]})")
        elif name.startswith("wkv6"):
            smem, at = (", ".join(f"{kn} {b}" for kn, b in wkv6_smem(name, RWKV_N).items()),
                        f"N={RWKV_N}")
        else:  # K6: static shared memory, as ptxas reports it
            smem = re.search(r"(\d+) bytes smem", " ".join(_build.ptxas_report(name)))[1]
            at = "any shape"
        log(f"[build] {name}: {smem} bytes of shared memory per block at {at}")

    clock = {"t": time.perf_counter()}

    def phase(name: str) -> None:
        now = time.perf_counter()
        log(f"[wall] {name} {now - clock['t']:.1f} s")
        clock["t"] = now

    worst = check_kernels(torch, dev)
    worst.update(check_training_kernels(torch, dev))
    worst.update(check_wkv6_kernels(torch, dev))
    worst.update(check_rglru_kernels(torch, dev))
    phase("kernel checks")
    timings = time_kernels(torch, dev, worst)
    timings.update(time_training_kernels(torch, dev, worst))
    timings.update(time_wkv6_kernels(torch, dev, worst))
    timings.update(time_rglru_kernels(torch, dev, worst))
    time_config_kernels(torch, dev, worst)
    timings.update(time_mla_kernels(torch, dev, worst))
    timings.update(time_encdec_kernels(torch, dev, worst))
    torch.cuda.empty_cache()
    phase("kernel timings")
    cfg, srv, specs, prompts, streams, _ = serve(torch, dev)
    serve_events = list(srv.trace_events())
    ticks_off = [e.dur for e in serve_events if e.name == "decode"]
    teacher_forced(torch, cfg, srv, specs, prompts, streams)
    profile_decode_tick(torch, cfg, srv.params)
    phase("serve and teacher-forced check")
    precompile_phase(smi)
    phase("precompile: two processes through one compile cache, cold then warm")
    RUNTIME_DIR.mkdir(parents=True, exist_ok=True)
    generate_phase(torch, cfg, srv, smi)
    del srv
    torch.cuda.empty_cache()
    phase("generate_with_scope and its dashboard")
    counts = serve_session(torch, cfg, specs, streams, ticks_off, smi)
    torch.cuda.empty_cache()
    phase("serve through the Session")
    counts.update(serve_paths(torch, smi))
    phase("serve paths: chunked, speculative, gathered with scope, static")
    route_phase(torch, smi, cfg, specs, prompts, streams, serve_events)
    phase("route: MegaRoute colocated, disaggregated and through the Session")
    serve_recurrent(torch, dev, "rwkv6-3b", RWKV_SERVE, smi, layers=RWKV_SERVE_LAYERS)
    phase("rwkv6 serve and teacher-forced check")
    griffin_serve_counts = serve_recurrent(torch, dev, "recurrentgemma-9b", GRIFFIN_SERVE,
                                           smi, min_table=GRIFFIN_TABLE,
                                           layers=GRIFFIN_SERVE_LAYERS)
    phase("griffin serve and teacher-forced check")
    recurrent_generate_phase(torch, smi)
    phase("generate_with_scope on rwkv6 and griffin")
    for arch, layers in DENSE_SERVE_LAYERS.items():
        serve_config(torch, arch, smi, layers=layers)
    phase("serve-dense: minitron-4b and minicpm-2b at 16 of 32 and 20 of 40 layers")
    serve_config(torch, "phi3.5-moe-42b-a6.6b", smi, layers=PHI_SERVE_LAYERS)
    phase("serve-moe: phi3.5-moe at 8 of 32 layers")
    serve_mla(torch, smi)
    phase(f"serve-mla: deepseek-v2-lite at {MLA_SERVE_LAYERS} of 27 layers on the "
          "gathered path")
    serve_encdec(torch, smi)
    phase("serve-encdec: seamless-m4t at all 48 layers, static, and its replays")
    # launches per pass (per_step_launches): qwen2-0.5b's one attention a
    # layer is above attn_kv_chunk (2048 > 1024: the flash branch), so
    # flash_fwd 2L = 48, flash_bwd L = 24, rmsnorm_fwd 2*2L + 1 = 97,
    # rmsnorm_bwd 2L + 1 = 49; the metrics module's flop count runs on the
    # meta device and adds no launch to the 8 steps
    # the dryrun's --all sweep runs on the CPU beside the training phases,
    # which keep the card busy; the serving phases before them are the host's
    background = start_dryrun_all()
    tcfg, data, train_counts, _ = train_session_phase(
        torch, dev, (flash_attention, rmsnorm), smi)
    step_check(torch, dev, tcfg, data, mixer="attn", tag="step",
               batch_step=TRAIN["steps"],
               tols=(STEP_LOSS_TOL, STEP_GNORM_RTOL, STEP_LEAF_RTOL))
    phase("qwen2 train through the Session and step check")
    runtime_phase(torch, dev, smi)
    trace_session, _ = _session(["trace", "--slow-rank", "5", "--iters", "2"])
    truth = trace_session.results["truth"]
    log(f"[trace] python -m repro_torch trace --slow-rank 5 --iters 2: slow ranks "
        f"{trace_session.results['diagnosis']['slow_ranks']}, truth "
        f"{truth['slow_ranks']}")
    if not truth["detected"]:
        raise AssertionError("the trace workload did not detect rank 5")
    phase("runtime: checkpoints, resume and the trace workload")
    ft_phase(torch, dev, smi)
    phase("ft: the supervised loop, chaos, guards and compression in one process")
    scope_phase(torch, smi)
    phase("scope: probes and perturbations through the qwen2 train step")
    fbd_phase(torch, dev, smi)
    phase("fbd: the decoupled forward and backward")
    cells2 = _parallel_jobs()[2]
    rows2 = pipeline_phase(torch, dev, smi,
                           also=(*(j for _, _, j in cells2), *ft_world_jobs()))
    phase("pipeline: MegaDPP's pp = 2 step, MegaFBD attached, the schedules; its "
          "world also runs the parallel phase's 2-rank cells and the ft world jobs")
    ft_world_check(torch, dev, smi, rows2[len(cells2):])
    phase("ft-world: dp 2 with a crash and a degraded link, pp 2 replanned to a wave")
    parallel_phase(torch, smi, done={2: rows2[:len(cells2)]})
    phase("parallel: dp 2, tp 2, pp 2 in two processes with MegaFBD, pp 2 x dp 2")
    # rwkv6-3b: ln1 and ln2 a layer (ln_x is a group norm in the time mix)
    # and one WKV recurrence, so wkv6_fwd 2L = 64, wkv6_bwd L = 32,
    # rmsnorm_fwd 2*2L + 1 = 129, rmsnorm_bwd 2L + 1 = 65
    rcfg, rdata, rwkv_counts, _ = train_phase(
        torch, dev, get_config("rwkv6-3b"), RWKV_TRAIN, (wkv6, rmsnorm), "train-rwkv")
    phase("rwkv6 train")
    step_check(torch, dev, rcfg.replace(num_layers=RWKV_STEP_LAYERS), rdata,
               mixer="att", tag="step-rwkv", batch_step=RWKV_TRAIN["steps"],
               tols=(RWKV_STEP_LOSS_TOL, RWKV_STEP_GNORM_RTOL, RWKV_STEP_LEAF_RTOL),
               probe=(rwkv_model, "wkv6"))
    phase("rwkv6 step check")
    # recurrentgemma-9b at full width, depth cut to 5 of 38 layers (rec,
    # rec, attn, rec, rec): the full model's train state (~150 GB) does not
    # fit one card.  rglru_fwd 2 x 4 rec layers = 8, rglru_bwd 4, flash_fwd
    # 2 x 1 attention layer = 2, flash_bwd 1, rmsnorm_fwd 2*2*5 + 1 = 21,
    # rmsnorm_bwd 2*5 + 1 = 11
    gcfg = get_config("recurrentgemma-9b").replace(num_layers=GRIFFIN_LAYERS)
    log(f"[train-griffin] depth cut: {GRIFFIN_LAYERS} of "
        f"{get_config('recurrentgemma-9b').num_layers} layers, full width")
    gcfg, gdata, griffin_counts, gstats = train_phase(
        torch, dev, gcfg, GRIFFIN_TRAIN, (rglru, flash_attention, rmsnorm),
        "train-griffin")
    if gstats["params"] != GRIFFIN_PARAMS:
        raise AssertionError(f"recurrentgemma-9b at {GRIFFIN_LAYERS} layers has "
                             f"{gstats['params']} parameters, not {GRIFFIN_PARAMS}")
    log(f"[train-griffin] first loss {gstats['losses'][0]:.4f}, ln V = "
        f"{math.log(gcfg.vocab_size):.4f}")
    phase("griffin train")
    step_check(torch, dev, gcfg, gdata, mixer="mix", tag="step-griffin",
               batch_step=GRIFFIN_TRAIN["steps"],
               tols=(GRIFFIN_STEP_LOSS_TOL, GRIFFIN_STEP_GNORM_RTOL,
                     GRIFFIN_STEP_LEAF_RTOL),
               probe=(griffin_model, "rglru_scan"))
    phase("griffin step check")
    train_configs_phase(torch, dev, smi)
    phase("train-configs: qwen2-vl-7b, minicpm-2b and phi3.5-moe, and their step checks")
    # deepseek-v2-lite at 4 layers: flash_fwd 2L = 8, flash_bwd L = 4,
    # rmsnorm_fwd 2*3L + 1 = 25, rmsnorm_bwd 3L + 1 = 13 a pass
    mla_counts = train_mla_phase(torch, dev, smi)
    phase("train-mla: deepseek-v2-lite at 4 layers and its step check")
    # seamless-m4t at full depth: flash_fwd 2 x (24 + 2 x 24) = 144, flash_bwd
    # 72 a step (the encoder, the cross-attention, the decoder), no K1
    encdec_counts = train_encdec_phase(torch, dev, smi)
    phase("train-encdec: seamless-m4t at all 48 layers and its step check")
    recurrent_scope_phase(torch, smi)
    phase("scope on rwkv6 and griffin")
    dryrun_phase(torch, dev, smi, background)
    phase("dryrun: the meta device's peak and flops against the card's, dryrun --all")

    # launches: the paged kernels' from the serve phase (K4 at the verify
    # and chunk shapes: the serve-paths phase's verify steps and chunks x
    # layers), K1's and K2's from
    # the qwen2 train phase (K2 at dh 256: the griffin train phase; at
    # 192 / 128: the train-mla phase; bidirectional: the train-encdec
    # phase), K5's
    # from the rwkv6 train phase, K6's from the griffin train phase (K1's
    # serve, rwkv6 and griffin counts are checked in those phases); K1's
    # tolerance: the absolute bound of its case nearest it; K2's, K5's and
    # K6's: the row-relative limits their ``max_row_err`` are held to
    counts.update(train_counts)
    counts.update({k: v for k, v in rwkv_counts.items() if k.startswith("wkv6")})
    counts.update({k: v for k, v in griffin_counts.items() if k.startswith("rglru")})
    counts.update({f"{k}_dh256": griffin_counts[k] for k in ("flash_fwd", "flash_bwd")})
    counts.update({f"{k}_mla": mla_counts[k] for k in ("flash_fwd", "flash_bwd")})
    counts.update({f"{k}_encdec": encdec_counts[k] for k in ("flash_fwd", "flash_bwd")})
    counts["paged_decode_dh256"] = griffin_serve_counts["paged_decode"]
    flash_src = "src/repro/kernels/flash_attention/kernel.py:86"
    wkv6_src = "src/repro/kernels/wkv6/kernel.py:79"
    rglru_src = "src/repro/kernels/rglru/kernel.py:49"
    norm_src = "src/repro/kernels/rmsnorm/kernel.py:26"
    norm_path = REPO / "src/repro_torch/kernels/rmsnorm/rmsnorm_triton.py"
    rows = [
        ("paged_decode", "cuda", _build.SOURCES["paged_decode"],
         "src/repro/kernels/paged_attention/kernel.py:139", None),
        ("paged_prefill", "cuda", _build.SOURCES["paged_prefill"],
         "src/repro/kernels/paged_attention/prefill_kernel.py:176", None),
        ("paged_decode_dh256", "cuda", _build.SOURCES["paged_decode"],
         "src/repro/kernels/paged_attention/kernel.py:139", None),
        ("paged_prefill_verify", "cuda", _build.SOURCES["paged_prefill"],
         "src/repro/kernels/paged_attention/prefill_kernel.py:176", None),
        ("paged_prefill_chunk", "cuda", _build.SOURCES["paged_prefill"],
         "src/repro/kernels/paged_attention/prefill_kernel.py:176", None),
        ("rmsnorm_fwd", "triton", norm_path, norm_src, None),
        ("rmsnorm_bwd", "triton", norm_path, norm_src, None),
        ("flash_fwd", "cuda", _build.SOURCES["flash_fwd"], flash_src, None),
        ("flash_bwd", "cuda", _build.SOURCES["flash_bwd"], flash_src, None),
        ("wkv6_fwd", "cuda", _build.SOURCES["wkv6_fwd"], wkv6_src, None),
        ("wkv6_bwd", "cuda", _build.SOURCES["wkv6_bwd"], wkv6_src, None),
        ("flash_fwd_dh256", "cuda", _build.SOURCES["flash_fwd"], flash_src, None),
        ("flash_bwd_dh256", "cuda", _build.SOURCES["flash_bwd"], flash_src, None),
        ("rglru_fwd", "cuda", _build.SOURCES["rglru_fwd"], rglru_src, None),
        ("rglru_bwd", "cuda", _build.SOURCES["rglru_bwd"], rglru_src, None),
        ("flash_fwd_mla", "cuda", _build.SOURCES["flash_fwd"], flash_src, None),
        ("flash_bwd_mla", "cuda", _build.SOURCES["flash_bwd"], flash_src, None),
        ("flash_fwd_encdec", "cuda", _build.SOURCES["flash_fwd"], flash_src, None),
        ("flash_bwd_encdec", "cuda", _build.SOURCES["flash_bwd"], flash_src, None),
    ]
    kernels = []
    for name, route, path, replaces, tol in rows:
        t = timings[name]
        kernels.append({
            "name": name, "route": route,
            "source": str(path.relative_to(REPO)), "replaces": replaces,
            "launches": counts[name], "max_abs_err": t["max_abs_err"],
            **{k: t[k] for k in ("max_row_err", "max_row_err_bf16", "tolerance_bf16")
               if k in t},
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
