"""Pipeline-parallel training on the port against the JAX package, on the
CPU in float32: ``restack_params`` and the layout refusals, the pipelined
loss and every gradient leaf against JAX's fused ``lm.loss_fn`` and
``jax.grad`` (``tests/test_pipeline.py``'s tolerances: loss rtol 2e-6,
leaves rtol 5e-4 / atol 1e-5), the pp = 2 train step's three-step losses
against JAX's fused step (rtol 2e-5), the pp = 1 plan and the MegaFBD attach
bit for bit, and the plan through ``Session``, the CLI, the ``dpp`` plugin
and the loop's MegaScan events.  JAX's side runs on one CPU device: its
fused loss, ``jax.grad``, ``make_train_step`` without a plan, the time
table and the event synthesis, none of which needs a mesh."""

import logging
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.app import plugins as jplugins  # noqa: E402
from repro.app.config import build_run_config as jbuild  # noqa: E402
from repro.app.session import Session as JSession  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core.dpp import executor as jexe  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import pipeline as jpl  # noqa: E402
from repro.parallel import plan as jplan  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.train_step import init_train_state as jinit_train_state  # noqa: E402
from repro.train.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.app import cli  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.dpp.executor import build_time_table, make_pipeline_stages  # noqa: E402
from repro_torch.core.dpp.schedule import sched_wave  # noqa: E402
from repro_torch.core.tracing.tracer import Tracer  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import pipeline as pl  # noqa: E402
from repro_torch.models.hooks import Collector  # noqa: E402
from repro_torch.models.weights import from_jax_params, from_jax_train_state  # noqa: E402
from repro_torch.parallel.plan import ParallelPlan, plan_summary, resolve_plan  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.loop import LoopConfig, train  # noqa: E402
from repro_torch.train.train_step import copy_state, make_train_step  # noqa: E402

# tests/test_pipeline.py's TINY, on both sides
_TINY = dict(
    name="pp-tiny", family="dense", num_layers=4, d_model=32, num_heads=4,
    num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=128, attn_kv_chunk=16,
    logits_chunk=16, vocab_pad_to=64,
    param_dtype="float32", compute_dtype="float32", remat="none",
)
TINY, JTINY = ModelConfig(**_TINY), JModelConfig(**_TINY)
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
ARCH = "qwen2-0.5b"


def _rwkv(mod_get):
    return mod_get("rwkv6-3b", smoke=True).replace(
        param_dtype="float32", compute_dtype="float32", remat="none")


# ------------------------------------------------------------- restacking ---


@pytest.mark.parametrize("layers,pp,n_chunks", [(4, 2, 2), (8, 2, 2), (8, 4, 1),
                                                (6, 3, 2), (8, 2, 1)])
def test_restack_params_equals_jax(layers, pp, n_chunks):
    layout = pl.pipeline_layout(TINY.replace(num_layers=layers), pp, n_chunks)
    jlayout = jpl.pipeline_layout(JTINY.replace(num_layers=layers), pp, n_chunks)
    assert (layout.kinds, layout.n_groups, layout.groups_per_cell) == (
        jlayout.kinds, jlayout.n_groups, jlayout.groups_per_cell)
    seg = np.arange(layers * 6, dtype=np.float32).reshape(layers, 2, 3)
    leaf = torch.from_numpy(seg.copy())
    out = pl.restack_params({"b0": {"w": leaf}}, layout)["b0"]["w"]
    ref = jpl.restack_params({"b0": {"w": jnp.asarray(seg)}}, jlayout)["b0"]["w"]
    assert np.array_equal(out.numpy(), np.asarray(ref))
    assert out.data_ptr() == leaf.data_ptr()  # a view of the canonical leaf


def _refusal(fn, exc=ValueError):
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


def test_pipeline_layout_refusals_equal_jax():
    cases = [
        (lambda m: m.replace(num_layers=5), dict(pp=2, n_chunks=2)),
        (lambda m: m.replace(family="moe"), dict(pp=2)),
        (lambda m: m.replace(input_kind="embeds_mrope"), dict(pp=2)),
    ]
    for edit, kw in cases:
        ours = _refusal(lambda: pl.pipeline_layout(edit(TINY), **kw))
        ref = _refusal(lambda: jpl.pipeline_layout(edit(JTINY), **kw))
        assert ours == ref
    # recurrentgemma-9b's 38 layers of (rec, rec, attn) form two segments, as
    # do the smoke config's 4
    for smoke in (False, True):
        ours = _refusal(lambda: pl.pipeline_layout(
            get_config("recurrentgemma-9b", smoke=smoke), pp=2))
        ref = _refusal(lambda: jpl.pipeline_layout(
            jax_get_config("recurrentgemma-9b", smoke=smoke), pp=2))
        assert ours == ref and "single uniform layer segment" in ours
    # the tensor split inside the stages: JAX's layout, and JAX's refusals
    # of other families and of widths tp does not divide
    assert pl.pipeline_layout(TINY, pp=2, tp=2).__dict__ == \
        jpl.pipeline_layout(JTINY, pp=2, tp=2).__dict__
    for edit in (lambda m: m.replace(num_kv_heads=1), lambda m: m.replace(use_mla=True)):
        assert _refusal(lambda: pl.pipeline_layout(edit(TINY), pp=2, tp=2)) == \
            _refusal(lambda: jpl.pipeline_layout(edit(JTINY), pp=2, tp=2))
    # qwen2-0.5b's 24 layers split in 2 stages x 2 chunks of 6
    layout = pl.pipeline_layout(get_config(ARCH), pp=2, n_chunks=2)
    assert layout.groups_per_cell == 6 and layout.kinds == ("dense",)


# ------------------------------------------------- loss / gradient parity ---


def _batch(cfg, B, S, seed, mask=True):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if mask:
        out["loss_mask"] = (rng.random((B, S)) > 0.1).astype(np.float32)
    return out


PARITY = [
    pytest.param(JTINY, TINY, 2, 2, id="tiny"),
    pytest.param(JTINY.replace(remat="full"), TINY.replace(remat="full"), 2, 2,
                 id="tiny-remat-full"),
    pytest.param(JTINY.replace(num_layers=8, remat="dots"),
                 TINY.replace(num_layers=8, remat="dots"), 2, 2, id="tiny-2-groups-a-cell"),
    pytest.param(_rwkv(jax_get_config), _rwkv(get_config), 2, 1, id="rwkv"),
]


@pytest.mark.parametrize("jcfg,cfg,pp,n_chunks", PARITY)
def test_pipeline_loss_and_grads_match_jax_fused(jcfg, cfg, pp, n_chunks):
    n_micro = 4
    params = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    batch = _batch(cfg, 4, 16, seed=1, mask=n_chunks == 2)
    jb = jax.tree.map(jnp.asarray, batch)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, jb), has_aux=True)(jax.tree.map(jnp.asarray, params))

    tp = from_jax_params(params, device="cpu")
    paths, flat = zip(*optim.leaves(tp))
    for leaf in flat:
        leaf.requires_grad_(True)
    layout = pl.pipeline_layout(cfg, pp, n_chunks)
    table = build_time_table(sched_wave(n_micro, n_chunks, 2), pp, n_chunks, n_micro)
    calls = []
    block = pl.make_block_fn(cfg, layout)
    loss, metrics = pl.pipeline_loss(
        cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()}, layout=layout,
        table=table, stages=make_pipeline_stages(pp, "cpu"), n_micro=n_micro,
        block_fn=lambda p, x: calls.append(1) or block(p, x))
    assert len(calls) == n_micro * pp * n_chunks
    np.testing.assert_allclose(loss.item(), float(jl), rtol=2e-6, atol=1e-6)
    assert metrics["ce"] is loss and metrics["aux_loss"].item() == 0.0
    grads = torch.autograd.grad(loss, flat)
    jflat = dict(optim.leaves(jax.tree.map(np.asarray, jg)))
    assert set(jflat) == set(paths)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), jflat[path], rtol=5e-4, atol=1e-5,
                                   err_msg=".".join(path))


def test_pipeline_loss_refuses_indivisible_batch():
    layout = pl.pipeline_layout(TINY, 2, 1)
    params = lm.init(TINY, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(TINY, 3, 8, 0).items()}
    with pytest.raises(ValueError, match="global batch 3 not divisible by n_micro=2"):
        pl.pipeline_loss(TINY, params, batch, layout=layout,
                         table=build_time_table([("F", 0, 0), ("F", 1, 0)], 2, 1, 2),
                         stages=make_pipeline_stages(2, "cpu"), n_micro=2)


# --------------------------------------------------- train-step parity ------


def _jax_losses(cfg, n_steps=3, batch=4, seq=16, grad_accum=1):
    data = JDataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch)
    ds = JSyntheticTokens(data)
    state = jinit_train_state(cfg, jax.random.PRNGKey(0))
    step = jax.jit(jmake_train_step(cfg, joptim.OptimizerConfig(**OCFG),
                                    grad_accum=grad_accum))
    init = jax.tree.map(np.asarray, state)
    losses = []
    for i in range(n_steps):
        state, m = step(state, ds.batch_at(i))
        losses.append(float(m["loss"]))
    return losses, init


def _torch_losses(cfg, init, plan=None, n_steps=3, batch=4, seq=16, grad_accum=1):
    ds = JSyntheticTokens(JDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=batch))
    state = from_jax_train_state(init, device="cpu")
    step = make_train_step(cfg, optim.OptimizerConfig(**OCFG), plan=plan,
                           grad_accum=grad_accum)
    losses = []
    for i in range(n_steps):
        state, m = step(state, {k: np.asarray(v) for k, v in ds.batch_at(i).items()})
        losses.append(m["loss"].item())
    return losses, state, step


@pytest.fixture(scope="module")
def jax_fused():
    return _jax_losses(JTINY)


@pytest.mark.parametrize("schedule", ["1f1b", "wave"])
def test_pp2_train_parity_three_steps(jax_fused, schedule):
    ref, init = jax_fused
    plan = resolve_plan(ParallelPlan(pp=2, n_micro=4, n_chunks=2, schedule=schedule))
    ours, _, step = _torch_losses(TINY, init, plan=plan)
    np.testing.assert_allclose(ours, ref, rtol=2e-5)
    info = step.pipeline
    assert info.plan == plan and info.layout.groups_per_cell == 1
    assert info.table.steps == jexe.build_time_table(
        jplan.forward_order(jplan.resolve_plan(jplan.ParallelPlan(
            pp=2, n_micro=4, n_chunks=2, schedule=schedule))), 2, 2, 4).steps


def test_pp2_grad_accum_runs_whole_pipeline_passes():
    ref, init = _jax_losses(JTINY, batch=8, grad_accum=2)
    plan = resolve_plan(ParallelPlan(pp=2, n_micro=2, n_chunks=2, schedule="dfc"))
    ours, _, _ = _torch_losses(TINY, init, plan=plan, batch=8, grad_accum=2)
    np.testing.assert_allclose(ours, ref, rtol=2e-5)


def test_pp1_plan_is_bitwise_identical_to_plain_step(jax_fused):
    _, init = jax_fused
    ref, ref_state, _ = _torch_losses(TINY, init)
    p1, p1_state, step = _torch_losses(TINY, init, plan=ParallelPlan(pp=1, n_micro=1))
    assert p1 == ref and not hasattr(step, "pipeline")
    for (_, a), (_, b) in zip(optim.leaves(p1_state.master),
                              optim.leaves(ref_state.master)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_fbd_backward_attach_is_bitwise_the_fused_pipelined_step(jax_fused, remat):
    """MegaFBD's forward instance and backward instance run the pipelined
    step's own graph: the same losses and updated parameters, bit for
    bit."""
    _, init = jax_fused
    cfg = TINY.replace(remat=remat)
    kw = dict(pp=2, n_micro=4, n_chunks=2, schedule="wave")
    fused, f_state, _ = _torch_losses(cfg, init, plan=resolve_plan(ParallelPlan(**kw)))
    dec, d_state, _ = _torch_losses(
        cfg, init, plan=resolve_plan(ParallelPlan(**kw, fbd_backward=True)))
    assert dec == fused
    for (_, a), (_, b) in zip(optim.leaves(d_state.master), optim.leaves(f_state.master)):
        assert torch.equal(a, b)


def test_pipeline_step_refuses_dp_tp_and_warns_on_probes(caplog):
    """A dp or tp plan needs the mesh of its ranks: without one the step is
    refused with JAX's message (``tests/test_torch_parallel.py`` runs it in
    its world); probes warn that pipelined blocks are not observed."""
    ocfg = optim.OptimizerConfig(**OCFG)
    for kw in (dict(dp=2), dict(tp=2)):
        with pytest.raises(ValueError, match="needs a mesh shaped"):
            make_train_step(TINY, ocfg, plan=resolve_plan(ParallelPlan(pp=2, **kw)))
    with caplog.at_level(logging.WARNING, logger="repro_torch.train"):
        make_train_step(TINY, ocfg, plan=resolve_plan(ParallelPlan(pp=2)),
                        collector=Collector())
    assert "do not observe pipelined blocks" in caplog.text


# ------------------------------------------- the loop's MegaScan events -----


def test_loop_emits_jax_pipeline_events():
    """Two pipelined steps through the loop: each ``train_step`` span is
    followed by the per-(microbatch, stage, F/B) events JAX's
    ``emit_pipeline_events`` makes from JAX's own table for the same plan,
    scaled into that span."""
    plan = resolve_plan(ParallelPlan(pp=2, n_micro=2, n_chunks=2))
    jtable = jexe.build_time_table(jplan.forward_order(jplan.resolve_plan(
        jplan.ParallelPlan(pp=2, n_micro=2, n_chunks=2))), 2, 2, 2)
    tracer = Tracer(rank=0, enabled=True)
    data = DataConfig(vocab_size=TINY.vocab_size, seq_len=16, global_batch=4)
    train(TINY, optim.OptimizerConfig(**OCFG), data, LoopConfig(n_steps=2, log_every=1),
          tracer=tracer, plan=plan, device="cpu")
    steps = [e for e in tracer.events if e.name == "train_step"]
    want = []
    for i, anchor in enumerate(steps):
        jexe.emit_pipeline_events(want, jtable, ts=anchor.ts, wall=anchor.dur, step_idx=i)
    got = [e for e in tracer.events if e.name in ("pp_F", "pp_B")]
    assert [e.to_json() for e in got] == [e.to_json() for e in want]
    assert len(got) == 2 * 2 * plan.n_micro * plan.n_chunks * plan.pp
    assert {e.rank for e in got} == {0, 1}
    for e in got:
        anchor = steps[e.args["step"]]
        assert anchor.ts <= e.ts and e.end <= anchor.end + 1e-9


# -------------------------------------------------- Session / CLI thread ----

_PP2 = ["train", "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
        "--set", "train.seq_len=32", "--set", "train.global_batch=4",
        "--pp", "2", "--n-micro", "2", "--pp-schedule", "wave"]


def test_cli_train_pp2_smoke_with_the_dpp_module():
    out = cli.run([*_PP2, "--modules", "scan,dpp"])
    res = out["session"].results
    jcfg = jbuild("train", arch=ARCH, smoke=True,
                  sets=["parallel.pp=2", "parallel.n_micro=2", "parallel.schedule=wave"])
    jplan_ = JSession(jcfg).parallel_plan()
    assert plan_summary(out["session"].parallel_plan()) == jplan.plan_summary(jplan_)
    # the plan, and the mesh of its two ranks (one stage each) on gloo
    assert {k: res["parallel"][k] for k in jplan.plan_summary(jplan_)} == \
        jplan.plan_summary(jplan_)
    assert res["parallel"]["mesh"] == {"stage": 2, "data": 1, "model": 1}
    assert res["parallel"]["stages"] == [0, 1] and res["parallel"]["backend"] == "gloo"
    assert [r["coords"]["stage"] for r in res["parallel"]["ranks"]] == [0, 1]
    assert res["parallel"]["wave"] >= 1  # the planner filled the wave in
    assert len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    # the dpp report: JAX DppPlugin's plan fields for the same section, and
    # the step times it folds in
    jdpp = jplugins.DppPlugin(jcfg)
    jdpp.setup(types.SimpleNamespace())
    assert {k: res["dpp"][k] for k in ("schedule", "wave", "makespan_ms",
                                       "peak_memory_mib")} == jdpp.finalize(None)
    assert set(res["dpp"]) == {"schedule", "wave", "makespan_ms", "peak_memory_mib",
                               "step_ms_p50", "step_ms_max"}
    assert res["dpp"]["step_ms_max"] >= res["dpp"]["step_ms_p50"] > 0
    names = [e.name for e in out["session"].tracer.events]
    assert names.count("pp_F") == names.count("pp_B") == 2 * 2 * 2 * 1


def test_cli_pp2_fbd_backward_trains_the_same_losses():
    off = cli.run([*_PP2, "--modules", "none"])
    on = cli.run([*_PP2, "--modules", "none", "--set", "parallel.fbd_backward=true"])
    assert [h["loss"] for h in on["history"]] == [h["loss"] for h in off["history"]]
    assert on["session"].results["parallel"]["fbd_backward"] is True


def test_session_rejects_indivisible_micro_with_jax_message():
    argv = ["train", "--arch", ARCH, "--smoke", "--steps", "1",
            "--set", "train.global_batch=4", "--set", "parallel.pp=2",
            "--set", "parallel.n_micro=3"]
    with pytest.raises(SystemExit) as ours:
        cli.main([*argv, "--device", "cpu", "--modules", "none"])
    from repro.app.cli import run as jrun

    with pytest.raises(SystemExit) as ref:
        jrun([*argv, "--modules", "none"])
    assert "not divisible by parallel.n_micro=3" in str(ours.value)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("sets", [["parallel.dp=2"], ["parallel.tp=2"],
                                  ["parallel.pp=2", "parallel.dp=2"],
                                  ["parallel.pp=2", "parallel.tp=2"]],
                         ids=lambda s: "-".join(s))
def test_dp_tp_train_on_the_cpu_in_their_ranks(sets):
    """The argv once refused naming item 8b train: the CLI spawns pp x dp x
    tp ranks on the CPU (gloo) and reports the plan, mesh and backend."""
    argv = ["train", "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1",
            "--set", "train.seq_len=32", "--set", "train.global_batch=8",
            "--modules", "none"]
    for s in sets:
        argv += ["--set", s]
    out = cli.run(argv)
    par = out["session"].results["parallel"]
    want = {k: int(v) for k, v in (s.split(".")[1].split("=") for s in sets)}
    assert {k: par[k] for k in want} == want
    assert par["backend"] == "gloo" and par["world"] == len(par["ranks"])
    assert par["mesh"] == {"stage": want.get("pp", 1), "data": want.get("dp", 1),
                           "model": want.get("tp", 1)}
    assert len(out["history"]) == 1 and np.isfinite(out["history"][0]["loss"])


def test_python_m_repro_torch_train_pp2_on_the_cpu():
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", *_PP2, "--set", "parallel.n_chunks=1",
         "--modules", "dpp"],
        capture_output=True, text=True, timeout=300, cwd=root,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"dpp": {"schedule"' in proc.stdout and '"parallel": {"dp": 1' in proc.stdout
    assert proc.stdout.count("loss ") == 2


def test_pipelined_state_copies_and_trains_on():
    """A step consumes its state: ``copy_state`` of a pipelined run's state
    trains on to the same losses as the original."""
    plan = resolve_plan(ParallelPlan(pp=2, n_micro=2))
    _, init = _jax_losses(JTINY, n_steps=0)
    state = from_jax_train_state(init, device="cpu")
    step = make_train_step(TINY, optim.OptimizerConfig(**OCFG), plan=plan)
    batch = _batch(TINY, 4, 16, seed=3, mask=False)
    a, ma = step(copy_state(state), batch)
    b, mb = step(state, batch)
    assert torch.equal(ma["loss"], mb["loss"])
    for (_, x), (_, y) in zip(optim.leaves(a.master), optim.leaves(b.master)):
        assert torch.equal(x, y)


def test_remat_full_keeps_only_each_groups_input_per_microbatch():
    """Under remat ``"full"`` a pipelined group keeps its input for the
    backward and recomputes the rest, as the fused forward's layers do: the
    residuals MegaFBD's forward instance hands over are the fused loss's
    less its positions (the pipeline's groups make theirs inside the
    checkpoint); without remat they are many times more."""
    from repro_torch.core.fbd import make_decoupled_step

    cfg = TINY.replace(remat="full")
    params = lm.init(cfg, seed=0, device="cpu")
    for _, leaf in optim.leaves(params):
        leaf.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 4, 16, seed=2).items()}
    plan = resolve_plan(ParallelPlan(pp=2, n_micro=2, n_chunks=2))

    def piped(c):
        kw = dict(layout=pl.pipeline_layout(c, 2, 2), stages=make_pipeline_stages(2, "cpu"),
                  table=build_time_table(sched_wave(2, 2, 1), 2, 2, 2), n_micro=plan.n_micro)
        return make_decoupled_step(lambda p, b: pl.pipeline_loss(c, p, b, **kw)[0])

    fused = make_decoupled_step(lambda p, b: lm.loss_fn(cfg, p, b)[0])
    S = batch["tokens"].shape[1]
    assert (piped(cfg).residual_bytes(params, batch)
            == fused.residual_bytes(params, batch) - S * 8)
    assert (piped(TINY).residual_bytes(params, batch)
            > 3 * piped(cfg).residual_bytes(params, batch))
