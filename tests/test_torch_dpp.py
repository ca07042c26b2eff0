"""MegaDPP on the port against ``repro.core.dpp``: schedules, time tables,
bubble fractions, the planner (also after ``replan`` with a MegaScan
``Diagnosis``), ``resolve_plan`` and ``emit_pipeline_events`` equal the JAX
package's exactly; ``tests/test_dpp.py``'s schedule, planner and engine
cases run again on the port; and the executor, on a toy block ``tanh(x @
p)``, matches JAX's ``reference_apply`` (outputs at rtol 1e-5, gradients
against ``jax.grad`` of it at rtol 1e-4), running only the table's active
cells.  Nothing here needs a multi-device JAX mesh."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.dpp import executor as jexe  # noqa: E402
from repro.core.dpp import planner as jplanner  # noqa: E402
from repro.core.dpp import schedule as jsched  # noqa: E402
from repro.core.simkit import workload as jworkload  # noqa: E402
from repro.core.tracing.detect import Diagnosis as JDiagnosis  # noqa: E402
from repro.parallel import plan as jplan  # noqa: E402
from repro_torch.core.dpp import executor as exe  # noqa: E402
from repro_torch.core.dpp import planner  # noqa: E402
from repro_torch.core.dpp import schedule as sched  # noqa: E402
from repro_torch.core.simkit import workload  # noqa: E402
from repro_torch.core.simkit.engine import DeadlockError, Engine, Task  # noqa: E402
from repro_torch.core.tracing.detect import Diagnosis  # noqa: E402
from repro_torch.parallel import plan as tplan  # noqa: E402

GRID = [(n, c) for n in (1, 2, 3, 5, 6, 8) for c in (1, 2, 3)]


# ------------------------------------------------------------- schedules ---


@pytest.mark.parametrize("n,c", GRID)
def test_schedules_equal_jax(n, c):
    for wave in range(1, n + 2):
        assert sched.sched_wave(n, c, wave) == jsched.sched_wave(n, c, wave)
    assert sched.sched_dfc(n, c) == jsched.sched_dfc(n, c)
    assert sched.sched_bfc(n, c) == jsched.sched_bfc(n, c)
    for pp in (1, 2, 4):
        for stage in range(pp):
            assert (sched.sched_1f1b(n, c, pp, stage)
                    == jsched.sched_1f1b(n, c, pp, stage))
            zb = sched.sched_zb_split(n, c, pp, stage)
            assert zb == jsched.sched_zb_split(n, c, pp, stage)
            assert workload.make_order("zb", n, c, pp, stage) == zb
            assert (sched.legalize(zb, n_chunks=c)
                    == jsched.legalize(zb, n_chunks=c))
    for order in (sched.sched_dfc(n, c), sched.sched_bfc(n, c)[::-1]):
        assert (sched.legalize(order, n_chunks=c)
                == jsched.legalize(order, n_chunks=c))
    per_stage = {s: sched.sched_1f1b(n, c, 3, s) for s in range(3)}
    assert (sched.schedule_table(per_stage, 3, c, n)
            == jsched.schedule_table(per_stage, 3, c, n))


def test_wave_poles_match_dfc_bfc():
    n, c = 6, 3
    w1 = sched.sched_wave(n, c, 1)
    assert w1[:2 * c] == [("F", 0, cc) for cc in range(c)] + [
        ("B", 0, cc) for cc in reversed(range(c))]
    assert sched.sched_wave(n, c, n)[: n * c] == sched.sched_bfc(n, c)[: n * c]


def test_zb_split_step_counts():
    n_micro, n_chunks, pp = 6, 2, 4
    cells = [(m, c) for m in range(n_micro) for c in range(n_chunks)]
    for stage in range(pp):
        steps = sched.sched_zb_split(n_micro, n_chunks, pp, stage)
        for kind in ("F", "B", "W"):
            assert sorted((m, c) for k, m, c in steps if k == kind) == cells
        seen_b = set()
        for kind, m, c in steps:
            if kind == "B":
                seen_b.add((m, c))
            elif kind == "W":
                assert (m, c) in seen_b


def test_make_order_dispatches_zb():
    assert "zb" in workload.SCHEDULE_NAMES
    assert workload.make_order("zb", 4, 2, 4, 1) == sched.sched_zb_split(4, 2, 4, 1)
    with pytest.raises(ValueError, match="unknown schedule"):
        workload.make_order("nope", 4, 2, 4, 0)


# ----------------------------------------------------------- time tables ---

TABLE_CASES = [
    # tests/test_pipeline.py::test_build_time_table_legality's cases
    ("dfc", 3, 2, 4), ("bfc", 4, 2, 2), ("wave2", 5, 2, 3), ("wave4", 4, 3, 2),
    # the chip's qwen2 and rwkv6 pipelines and the four schedules at S = 2
    ("wave2", 4, 2, 2), ("1f1b", 4, 2, 2), ("dfc", 4, 2, 2), ("bfc", 4, 1, 2),
    ("wave1", 8, 2, 4), ("1f1b", 8, 2, 4), ("wave3", 7, 3, 3), ("dfc", 1, 1, 1),
]


def _order(mod, name, n, c, S):
    if name == "1f1b":
        return mod.sched_1f1b(n, c, S, 0)
    if name.startswith("wave"):
        return mod.sched_wave(n, c, int(name[4:]))
    return getattr(mod, f"sched_{name}")(n, c)


@pytest.mark.parametrize("name,n_micro,n_chunks,S", TABLE_CASES)
def test_time_table_equals_jax(name, n_micro, n_chunks, S):
    ours = exe.build_time_table(_order(sched, name, n_micro, n_chunks, S), S,
                                n_chunks, n_micro)
    ref = jexe.build_time_table(_order(jsched, name, n_micro, n_chunks, S), S,
                                n_chunks, n_micro)
    assert ours.steps == ref.steps
    for field in ("run_m", "run_c", "run_act", "recv_m", "recv_c", "recv_act",
                  "recv_fin"):
        a, b = getattr(ours, field), np.asarray(getattr(ref, field))
        assert a.shape == b.shape == (ref.steps, S) and a.dtype == b.dtype, field
        assert np.array_equal(a, b), field
    assert exe.bubble_fraction(ours) == jexe.bubble_fraction(ref)
    assert int(ours.run_act.sum()) == n_micro * n_chunks * S


def test_cyclic_order_is_refused():
    with pytest.raises(RuntimeError, match="legalized"):
        exe.build_time_table([("F", 0, 1)], 2, 2, 1)


# --------------------------------------------------------------- planner ---

TOPOLOGIES = [
    # tests/test_dpp.py's planner topologies, and the dpp section's default
    dict(topo=(1, 4, 1), prof=dict(n_chunks=2, act_bytes=1 << 20), n_micro=8,
         cap=1 << 40),
    dict(topo=(1, 4, 1), prof=dict(n_chunks=2, act_bytes=1 << 20), n_micro=8,
         cap=(1 << 20) * 9),
    dict(topo=(1, 4, 1), prof=dict(n_chunks=2), n_micro=8, cap=16 << 30),
    dict(topo=(2, 2, 2), prof=dict(n_chunks=1), n_micro=4, cap=8 << 30),
    dict(topo=(1, 2, 1), prof=dict(n_chunks=2), n_micro=4, cap=1 << 30),
]


def _plans(case, mod_planner, mod_workload, diag=None):
    pl = mod_planner.Planner(
        mod_workload.Topology(*case["topo"]), mod_workload.ModelProfile(**case["prof"]),
        n_micro=case["n_micro"], memory_cap=case["cap"])
    first = pl.plan()
    return first, (pl.replan(diag) if diag is not None else None), pl


def _fields(r):
    return (r.schedule_name, r.wave, r.makespan, r.peak_memory, r.grad_ready,
            r.per_candidate)


@pytest.mark.parametrize("case", TOPOLOGIES, ids=lambda c: f"{c['topo']}-{c['cap']}")
def test_planner_equals_jax(case):
    diag = dict(slow_ranks=[1], candidate_ranks=[1], degraded_links=[(0, 1)])
    ours, ours_re, pl = _plans(case, planner, workload, Diagnosis(**diag))
    ref, ref_re, jpl = _plans(case, jplanner, jworkload, JDiagnosis(**diag))
    assert _fields(ours) == _fields(ref)
    assert _fields(ours_re) == _fields(ref_re)
    assert pl.faults.compute_slowdown == jpl.faults.compute_slowdown
    assert ours.steps(case["n_micro"], case["prof"]["n_chunks"]) == ref.steps(
        case["n_micro"], case["prof"]["n_chunks"])


def test_planner_best_effort_respects_memory_cap():
    topo = workload.Topology(dp=1, pp=4, tp=1)
    prof = workload.ModelProfile(n_chunks=2, act_bytes=1 << 20)
    loose = planner.Planner(topo, prof, n_micro=8, memory_cap=1 << 40).plan()
    tight_cap = loose.peak_memory - 1
    tight = planner.Planner(topo, prof, n_micro=8, memory_cap=tight_cap).plan()
    assert tight.wave <= loose.wave
    assert tight.peak_memory <= tight_cap or tight.wave == 1


def test_planner_reacts_to_telemetry():
    pl = planner.Planner(workload.Topology(dp=1, pp=4, tp=1),
                         workload.ModelProfile(n_chunks=2), n_micro=8)
    base = pl.plan()
    new = pl.replan(Diagnosis(slow_ranks=[2], candidate_ranks=[2], degraded_links=[]))
    assert new.makespan > base.makespan
    assert 2 in pl.faults.compute_slowdown


def test_dfc_lower_memory_bfc_earlier_grads():
    topo = workload.Topology(dp=1, pp=4, tp=1)
    prof = workload.ModelProfile(n_chunks=2, act_bytes=1 << 20)

    def run(wave):
        steps = sched.sched_wave(8, prof.n_chunks, wave)
        res = Engine().run(workload.build_training_step(
            topo, prof, n_micro=8, schedule={p: list(steps) for p in range(topo.pp)}))
        chunk0 = max(r.end for r in res.records if r.kind == "compute"
                     and r.meta.get("phase") == "B" and r.meta.get("chunk") == 0)
        return max(res.peak_memory.values()), chunk0 / res.makespan

    (peak_dfc, frac_dfc), (peak_bfc, frac_bfc) = run(1), run(8)
    assert peak_dfc < peak_bfc
    assert frac_bfc <= frac_dfc + 1e-9


def test_async_p2p_and_zb_reduce_makespan():
    topo = workload.Topology(dp=1, pp=4, tp=1)
    prof = workload.ModelProfile(p2p_bytes=64 << 20, fwd_time=5e-4, bwd_time=1e-3)
    mk_sync = Engine(link_concurrency=1).run(
        workload.build_training_step(topo, prof, n_micro=8, async_p2p=False)).makespan
    mk_async = Engine(link_concurrency=4).run(
        workload.build_training_step(topo, prof, n_micro=8, async_p2p=True)).makespan
    assert mk_async < mk_sync
    prof = workload.ModelProfile(fwd_time=1e-3, bwd_time=2e-3)
    mk_1f1b = Engine().run(workload.build_training_step(
        topo, prof, n_micro=8, schedule="1f1b")).makespan
    mk_zb = Engine().run(workload.build_training_step(
        topo, prof, n_micro=8, schedule="zb")).makespan
    ref_zb = jplanner.Engine().run(jworkload.build_training_step(
        jworkload.Topology(dp=1, pp=4, tp=1),
        jworkload.ModelProfile(fwd_time=1e-3, bwd_time=2e-3),
        n_micro=8, schedule="zb")).makespan
    assert 8 * (prof.fwd_time + prof.bwd_time) < mk_zb < mk_1f1b
    assert mk_zb == ref_zb


def test_engine_detects_deadlock_on_mismatched_collective_order():
    a1 = dict(kind="allreduce", bytes=8, group=(0, 1))
    order = {
        0: [Task(tid="cA_0", rank=0, coll_id="cA", **a1),
            Task(tid="cB_0", rank=0, coll_id="cB", **a1)],
        1: [Task(tid="cB_1", rank=1, coll_id="cB", **a1),
            Task(tid="cA_1", rank=1, coll_id="cA", **a1)],
    }
    with pytest.raises(DeadlockError):
        Engine().run(order)


@pytest.mark.parametrize("kw", [
    dict(pp=2, n_micro=8, n_chunks=2, schedule="wave", wave=0),
    dict(pp=4, schedule="wave"),
    dict(pp=2, n_micro=4, n_chunks=2, schedule="1f1b"),
    dict(pp=1, n_micro=2),
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_resolve_plan_and_forward_order_equal_jax(kw):
    ours = tplan.resolve_plan(tplan.ParallelPlan(**kw), memory_cap_gib=4.0)
    ref = jplan.resolve_plan(jplan.ParallelPlan(**kw), memory_cap_gib=4.0)
    assert tplan.plan_summary(ours) == jplan.plan_summary(ref)
    if ours.pp > 1:
        assert 1 <= ours.wave or ours.schedule != "wave"
        assert tplan.forward_order(ours) == jplan.forward_order(ref)
    for link in [(0, 1), (0, 0), (0, 99)]:
        assert tplan.link_axis(ours, link) == jplan.link_axis(ref, link)


def test_plan_guards_equal_jax():
    for kw in (dict(pp=2, schedule="zigzag"), dict(pp=0), dict(pp=2, dp=2, n_micro=3)):
        with pytest.raises(ValueError) as ours:
            tplan.resolve_plan(tplan.ParallelPlan(**kw))
        with pytest.raises(ValueError) as ref:
            jplan.resolve_plan(jplan.ParallelPlan(**kw))
        assert str(ours.value) == str(ref.value)


# -------------------------------------------------------------- executor ---

S, C, N_MICRO, B, D = 4, 2, 4, 2, 8


def _toy(seed):
    rng = np.random.default_rng(seed)
    params = (0.3 * rng.standard_normal((S, C, D, D))).astype(np.float32)
    x = rng.standard_normal((N_MICRO, B, D)).astype(np.float32)
    tgt = rng.standard_normal((N_MICRO, B, D)).astype(np.float32)
    return params, x, tgt


def _counting_block():
    calls = []

    def block(p, x):
        calls.append(1)
        return torch.tanh(x @ p)

    return block, calls


def _jblock(p, x):
    return jnp.tanh(x @ p)


@pytest.mark.parametrize("wave", [1, 2, 4])
def test_executor_matches_jax_reference(wave):
    params, x, _ = _toy(0)
    table = exe.build_time_table(sched.sched_wave(N_MICRO, C, wave), S, C, N_MICRO)
    block, calls = _counting_block()
    out = exe.pipeline_apply(torch.from_numpy(params), torch.from_numpy(x), table,
                             stages=exe.make_pipeline_stages(S, "cpu"), block_fn=block)
    assert len(calls) == N_MICRO * S * C  # only the table's active cells run
    ref = jexe.reference_apply(jnp.asarray(params), jnp.asarray(x), _jblock)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    ours_ref = exe.reference_apply(torch.from_numpy(params), torch.from_numpy(x),
                                   lambda p, v: torch.tanh(v @ p))
    np.testing.assert_allclose(ours_ref.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wave", [1, 2, 4])
def test_executor_gradients_match_jax_reference(wave):
    params, x, tgt = _toy(2)
    table = exe.build_time_table(sched.sched_wave(N_MICRO, C, wave), S, C, N_MICRO)
    p = torch.from_numpy(params).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    block, calls = _counting_block()
    out = exe.pipeline_apply(p, xt, table, stages=exe.make_pipeline_stages(S, "cpu"),
                             block_fn=block)
    g_p, g_x = torch.autograd.grad(((out - torch.from_numpy(tgt)) ** 2).mean(), (p, xt))
    assert len(calls) == N_MICRO * S * C

    def jloss(pp, xx):
        return jnp.mean((jexe.reference_apply(pp, xx, _jblock) - tgt) ** 2)

    j_p, j_x = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(params), jnp.asarray(x))
    np.testing.assert_allclose(g_p.numpy(), np.asarray(j_p), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_x.numpy(), np.asarray(j_x), rtol=1e-4, atol=1e-5)


def test_executor_takes_a_tree_of_stacked_leaves():
    params, x, _ = _toy(3)
    tree = {"w": torch.from_numpy(params), "inner": {"b": torch.ones(S, C, D)}}
    table = exe.build_time_table(sched.sched_1f1b(N_MICRO, C, S, 0), S, C, N_MICRO)
    out = exe.pipeline_apply(tree, torch.from_numpy(x), table,
                             stages=exe.make_pipeline_stages(S, "cpu"),
                             block_fn=lambda p, v: torch.tanh(v @ p["w"] + p["inner"]["b"]))
    ref = exe.reference_apply(tree, torch.from_numpy(x),
                              lambda p, v: torch.tanh(v @ p["w"] + p["inner"]["b"]))
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="stages"):
        exe.pipeline_apply(tree, torch.from_numpy(x), table,
                           stages=exe.make_pipeline_stages(2, "cpu"), block_fn=None)


# ---------------------------------------------------------------- events ---


@pytest.mark.parametrize("name,n_micro,n_chunks,S_", [
    ("dfc", 3, 2, 2), ("wave2", 4, 2, 2), ("1f1b", 8, 2, 4)])
def test_emit_pipeline_events_equals_jax(name, n_micro, n_chunks, S_):
    order = _order(sched, name, n_micro, n_chunks, S_)
    ours, ref = [], []
    exe.emit_pipeline_events(ours, exe.build_time_table(order, S_, n_chunks, n_micro),
                             ts=10.0, wall=1.0, step_idx=3)
    jexe.emit_pipeline_events(ref, jexe.build_time_table(order, S_, n_chunks, n_micro),
                              ts=10.0, wall=1.0, step_idx=3)
    assert [e.to_json() for e in ours] == [e.to_json() for e in ref]
    f = [e for e in ours if e.name == "pp_F"]
    assert len(f) == n_micro * n_chunks * S_
    assert all(10.0 <= e.ts and e.end <= 11.0 + 1e-9 for e in ours)
