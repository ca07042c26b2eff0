"""MegaFT on the port (``repro_torch.ft``, the supervised ``train.loop``,
the ``ft`` and ``scan --detect-online`` plugins) held to the JAX package's
``repro.ft`` and ``repro.train.loop.train`` on the CPU.

* ``GradCompressor``'s compressed gradients and error buffers are
  bit-equal to JAX's (float32 and bfloat16 trees with all-zero blocks and
  sizes that are not a multiple of the block), and so are its wire bytes.
* Chaos specs, injectors, the offline ``simulate_policy``, the mitigation
  policy and ``FtController`` give JAX's values on the same inputs
  (``tests/test_ft.py``'s passing classes, on both sides), and
  ``TrainSupervisor`` recovers as ``TestSupervisorRecovery`` asks.
* The supervised loop against JAX's ``train`` called directly, float32
  qwen2 smoke at seq 32 x batch 2, both from JAX's initial state: a crash
  and a NaN rollback (history at rtol 2e-5, timeline and ``report()``
  equal), the skip guard, and int8 compression switched on at step 3 by
  the same synthetic degraded-link update to both controllers (rtol 1e-4:
  one int8 level can flip where float32 roundings differ).
* The CLI and ``Session`` runs of ``tests/test_ft.py``'s ``TestGuards``,
  ``TestMitigationExecution``, ``TestCliFlags`` and ``TestChaosAcceptance``
  on the port, with their assertions; their JAX classes fail through
  ``Session`` on this tree (ROADMAP R3), so the port is held to what they
  assert.  The pipeline replan runs in a world of ranks
  (``tests/test_torch_ft_world.py``).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import ft as jft  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.tracing.detect import Diagnosis as JDiagnosis  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.obs.detector import DetectionUpdate as JDetectionUpdate  # noqa: E402
from repro.train.loop import LoopConfig as JLoopConfig  # noqa: E402
from repro.train.loop import StepHooks as JStepHooks  # noqa: E402
from repro.train.loop import train as jax_train  # noqa: E402
from repro.train.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.train.train_step import init_train_state as jinit_state  # noqa: E402
from repro_torch import ft  # noqa: E402
from repro_torch.app import cli  # noqa: E402
from repro_torch.checkpoint.checkpointer import save  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tracing.detect import Diagnosis  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.models.weights import from_jax_train_state  # noqa: E402
from repro_torch.obs.detector import DetectionUpdate  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train.loop import LoopConfig, StepHooks, train  # noqa: E402
from repro_torch.train.optim import OptimizerConfig  # noqa: E402

ARCH = "qwen2-0.5b"
SEQ, BATCH = 32, 2
HIST_RTOL = 2e-5      # the supervised histories, float32
COMP_RTOL = 1e-4      # with int8 compression on
TINY = ["--arch", ARCH, "--smoke", "--device", "cpu",
        "--seq-len", str(SEQ), "--global-batch", str(BATCH)]


def _run(extra):
    out = cli.run(["train", *TINY, *extra])
    return {**out["session"].results, "history": out["history"]}


# ------------------------------------------------------------ compressor ---


def _grad_tree(rng):
    """Gradients with an all-zero leaf, a leaf with one all-zero block, sizes
    off the 256-block grid and magnitudes from 1e-6 to 1e2."""
    shapes = {"a": (3, 100), "b": {"c": (256,), "d": (513,), "z": (700,)},
              "e": (7,)}

    def draw(shape, key):
        x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 3)).astype(np.float32)
        if key == "z":
            x[:] = 0
        if key == "d":
            x[256:512] = 0
        return x

    def make(node, key=""):
        return ({k: make(v, k) for k, v in node.items()} if isinstance(node, dict)
                else draw(node, key))

    return make(shapes)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressor_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    g = _grad_tree(rng)
    err = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-3)
                       .astype(np.float32), g)
    err["b"]["z"][:] = 0  # an all-zero block with no residual to carry
    jc, jerr = jft.GradCompressor().apply(
        jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), g),
        jax.tree.map(jnp.asarray, err))
    tg = jax.tree.map(lambda x: torch.from_numpy(x).to(getattr(torch, dtype)), g)
    pc, perr = ft.GradCompressor().apply(tg, jax.tree.map(torch.from_numpy, err))
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(pc), strict=True):
        assert str(b.dtype) == f"torch.{dtype}"
        np.testing.assert_array_equal(_bits(np.asarray(a.astype(jnp.float32))),
                                      _bits(b.float().numpy()))
    for a, b in zip(jax.tree.leaves(jerr), jax.tree.leaves(perr), strict=True):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(_bits(np.asarray(a)), _bits(b.numpy()))
    # the all-zero leaf stays zero, with no residual
    assert not pc["b"]["z"].any() and not perr["b"]["z"].any()
    assert ft.GradCompressor().wire_bytes(tg) == jft.GradCompressor().wire_bytes(
        jax.tree.map(jnp.asarray, g))


def test_compressor_init_and_error_feedback_converges():
    """Zero float32 buffers shaped like the params; with feedback the mean
    of the compressed gradients over many steps approaches the true one."""
    comp = ft.GradCompressor()
    g = {"w": torch.linspace(-1.0, 1.0, 1000) * 1e-3 + 0.3}
    err = comp.init(g)
    assert err["w"].dtype == torch.float32 and not err["w"].any()
    total = torch.zeros(1000)
    for _ in range(64):
        c, err = comp.apply(g, err)
        total += c["w"]
    assert float((total / 64 - g["w"]).abs().max()) < 1e-4


# ------------------------------------------------------- chaos + policy ---


def test_parse_link_and_spec_flags_equal_jax():
    assert ft.parse_link("0-1") == jft.parse_link("0-1") == (0, 1)
    assert ft.parse_link("12-3") == (12, 3)
    with pytest.raises(ValueError, match="src-dst"):
        ft.parse_link("nope")
    for kw in ({}, {"nan_at_step": 2}, {"slow_rank_from": 0},
               {"degrade_link": "0-1"}, {"crash_at_step": 5}):
        ours, theirs = ft.ChaosSpec(**kw), jft.ChaosSpec(**kw)
        assert (ours.active, ours.needs_restore) == (theirs.active, theirs.needs_restore)


def test_to_fault_model_equals_jax():
    for kw in (dict(slow_rank_from=0, slow_rank=2, slow_factor=0.4,
                    degrade_link="1-0", degrade_factor=0.2),
               dict(crash_at_step=3)):
        ours = ft.ChaosSpec(**kw).to_fault_model()
        theirs = jft.ChaosSpec(**kw).to_fault_model()
        assert ours.compute_slowdown == theirs.compute_slowdown
        assert ours.link_slowdown == theirs.link_slowdown
        assert (ours.jitter, ours.seed) == (theirs.jitter, theirs.seed)


def test_injector_fires_once_as_jax():
    spec = dict(crash_at_step=5, nan_at_step=3, slow_rank_from=4)
    ours, theirs = ft.ChaosInjector(ft.ChaosSpec(**spec)), jft.ChaosInjector(
        jft.ChaosSpec(**spec))
    batch = {"tokens": np.zeros((2, 4), np.int32),
             "loss_mask": np.ones((2, 4), np.float32)}
    for step in (2, 3, 3, 4, 5, 5, 6):
        assert ours.crash_due(step) == theirs.crash_due(step)
        assert ours.slow_active(step) == theirs.slow_active(step)
        a, b = ours.poison_batch(batch, step), theirs.poison_batch(batch, step)
        assert (a is batch) == (b is batch)
        np.testing.assert_array_equal(a["loss_mask"], b["loss_mask"])
    assert not np.isnan(batch["loss_mask"]).any()  # the original untouched
    assert ours.fired == theirs.fired == {"crash", "nan"}
    assert ours.link() is None
    assert ft.ChaosInjector(ft.ChaosSpec(degrade_link="1-0")).link() == (1, 0)


@pytest.mark.parametrize("kw,action", [
    ({}, "none"),
    (dict(slow_rank_from=0, slow_rank=1, slow_factor=0.5), "exclude"),
    (dict(degrade_link="0-1"), "replan"),
], ids=["healthy", "hard-straggler", "degraded-link"])
def test_simulate_policy_equals_jax(kw, action):
    diag, act, info = ft.simulate_policy(ft.ChaosSpec(**kw))
    jdiag, jact, jinfo = jft.simulate_policy(jft.ChaosSpec(**kw))
    assert act.value == jact.value == action
    assert diag.summary() == jdiag.summary()
    assert diag.evidence == jdiag.evidence
    assert info == jinfo
    if action == "exclude":
        assert 1 in diag.slow_ranks and info["severity"] >= 0.7
    if action == "replan":
        assert (0, 1) in {tuple(l) for l in diag.degraded_links}


def _diag(cls, ranks=(), links=(), frac=0.9, n_inst=50):
    return cls(slow_ranks=list(ranks), candidate_ranks=list(ranks),
               degraded_links=[tuple(l) for l in links],
               rank_scores={r: {"slow_op_frac": frac} for r in ranks},
               evidence={"n_instances": n_inst})


_DIAGS = [dict(ranks=(1,)), dict(ranks=(1,), n_inst=3), dict(),
          dict(ranks=(2,), frac=0.4), dict(links=((0, 1),)),
          dict(ranks=(1, 3), frac=0.7), dict(ranks=(1,), frac=0.69)]


def test_mitigation_policy_equals_jax():
    for soft, hard, ev in ((0.3, 0.7, 8), (0.3, 1.1, 8), (0.1, 0.5, 60)):
        ours = ft.MitigationPolicy(slow_frac_soft=soft, slow_frac_hard=hard,
                                   min_evidence=ev)
        theirs = jft.MitigationPolicy(slow_frac_soft=soft, slow_frac_hard=hard,
                                      min_evidence=ev)
        for kw in _DIAGS:
            a, ia = ours.decide(_diag(Diagnosis, **kw))
            b, ib = theirs.decide(_diag(JDiagnosis, **kw))
            assert (a.value, ia) == (b.value, ib), kw


# ------------------------------------------------------------ controller ---


def _updates(step, **kw):
    return (DetectionUpdate(step=step, diagnosis=_diag(Diagnosis, **kw)),
            JDetectionUpdate(step=step, diagnosis=_diag(JDiagnosis, **kw)))


def test_controller_decisions_equal_jax():
    """Decisions once per signature, exclusions not re-decided, NONE on
    thin evidence, replans for soft stragglers and links: the same pending
    actions, timeline and report as JAX's controller."""
    ours, theirs = ft.FtController(), jft.FtController()
    seq = [(8, dict(ranks=(1,))), (12, dict(ranks=(1,))),
           (4, dict(ranks=(1,), n_inst=3)), (16, dict(ranks=(2,), frac=0.4)),
           (16, dict(links=((0, 1),))), (20, dict(ranks=(1, 3)))]
    for i, (step, kw) in enumerate(seq):
        if i == 2:
            ours.excluded.add(1)
            theirs.excluded.add(1)
        a, b = _updates(step, **kw)
        ours.on_detection(a)
        theirs.on_detection(b)
        assert ([dataclasses.asdict(x) for x in ours.poll()]
                == [dataclasses.asdict(x) for x in theirs.poll()])
    assert ours.poll() == []
    assert ours.report() == theirs.report()
    events = [t["event"] for t in ours.timeline]
    assert events == ["decide:exclude", "decide:replan", "decide:replan",
                      "decide:exclude"]
    assert ours.detections == 6


def test_controller_guards_and_accounting_equal_jax():
    for opts in (dict(guard_action="rollback"),
                 dict(guard_spike=10.0, guard_action="skip"),
                 dict(guard_nan=False, guard_action="skip")):
        ours = ft.FtController(options=ft.FtOptions(**opts))
        theirs = jft.FtController(options=jft.FtOptions(**opts))
        seq = [(s, 1.0, 1.0) for s in range(8)] + [
            (8, 1.0, 50.0), (9, float("nan"), 0.5), (10, 1.0, float("inf")),
            (11, 1.0, 1.0)]
        for step, loss, gn in seq:
            assert ours.check_guards(step, loss, gn) == theirs.check_guards(step, loss, gn)
        ours.record_restart(6, 3, "InjectedCrash")
        theirs.record_restart(6, 3, "InjectedCrash")
        ours.record_rollback(9, 6)
        theirs.record_rollback(9, 6)
        assert ours.report() == theirs.report()
    assert ours.report()["timeline"][0]["details"]["resumed_step"] == 3


def test_effective_obs_folds_chaos_and_exclusions_as_jax():
    from repro.obs import RankEventSpec as JRankEventSpec
    from repro_torch.obs import RankEventSpec

    spec = dict(slow_rank_from=2, slow_rank=1, slow_factor=0.4,
                degrade_link="0-1", degrade_factor=0.3)
    ours = ft.FtController(chaos=ft.ChaosInjector(ft.ChaosSpec(**spec)))
    theirs = jft.FtController(chaos=jft.ChaosInjector(jft.ChaosSpec(**spec)))
    for step in (0, 2, 5):
        if step == 5:
            ours.excluded.add(1)
            theirs.excluded.add(1)
        a = ours.effective_obs(RankEventSpec(dp=2), step)
        b = theirs.effective_obs(JRankEventSpec(dp=2), step)
        assert vars(a) == vars(b)
    assert ours.effective_obs(None, 0) is None


# ------------------------------------------------------------ supervisor ---


class TestSupervisorRecovery:
    def test_history_truncated_after_rollback(self, tmp_path):
        calls = {"n": 0}

        def step_fn(state, batch):
            calls["n"] += 1
            if calls["n"] == 7:  # dies at step 6, after the ckpt at step 4
                raise RuntimeError("device loss")
            return {"w": state["w"] + batch["x"]}, {"loss": torch.tensor(0.0)}

        sup = ft.TrainSupervisor(
            step_fn=step_fn, make_batch=lambda s: {"x": torch.tensor(float(s))},
            ckpt_dir=str(tmp_path), ckpt_every=4, max_restarts=2)
        state, step = sup.run({"w": torch.tensor(0.0)}, n_steps=10)
        assert step == 10
        steps = [h["step"] for h in sup.history]
        assert steps == sorted(set(steps)) == list(range(10))
        assert float(state["w"]) == sum(range(10))

    def test_background_save_error_does_not_mask_step_failure(
            self, tmp_path, monkeypatch):
        import repro_torch.checkpoint.checkpointer as ckpt_mod

        save({"w": torch.tensor(0.0)}, 0, tmp_path)
        real_write = ckpt_mod._write
        fails = {"left": 1}

        def flaky_write(*a, **k):
            if fails["left"]:
                fails["left"] -= 1
                raise OSError("save died")
            return real_write(*a, **k)

        monkeypatch.setattr(ckpt_mod, "_write", flaky_write)
        calls = {"n": 0}

        def step_fn(state, batch):
            calls["n"] += 1
            if calls["n"] == 6:  # after the (failed) background save at 4
                raise RuntimeError("step boom")
            return {"w": state["w"] + batch["x"]}, {}

        sup = ft.TrainSupervisor(
            step_fn=step_fn, make_batch=lambda s: {"x": torch.tensor(float(s))},
            ckpt_dir=str(tmp_path), ckpt_every=4, max_restarts=2)
        state, step = sup.run({"w": torch.tensor(0.0)}, n_steps=8)
        assert step == 8 and float(state["w"]) == sum(range(8))

    def test_exhausted_restarts_reraise(self, tmp_path):
        def step_fn(state, batch):
            raise RuntimeError("always")

        save({"w": torch.tensor(0.0)}, 0, tmp_path)
        sup = ft.TrainSupervisor(step_fn=step_fn, make_batch=lambda s: {},
                                 ckpt_dir=str(tmp_path), max_restarts=1)
        with pytest.raises(RuntimeError, match="always"):
            sup.run({"w": torch.tensor(0.0)}, n_steps=2)


# ------------------------------------- the supervised loop against JAX's ---


@pytest.fixture(scope="module")
def jstate0():
    jcfg = jax_get_config(ARCH, smoke=True).replace(compute_dtype="float32")
    return jax.tree.map(np.asarray, jinit_state(jcfg, jax.random.PRNGKey(0)))


def _loops(tmp_path, jstate0, monkeypatch, *, steps, spec=None, options=None,
           ckpt_every=2, on_step=None):
    """JAX's ``train`` and the port's on float32 qwen2 smoke from JAX's
    initial state, each with a controller of ``spec`` and ``options``:
    ``(jax history, jax controller, port history, port controller)``.
    ``on_step(i, controller, make_update)`` runs after the i-th step of
    each side."""
    jcfg = jax_get_config(ARCH, smoke=True).replace(compute_dtype="float32")
    cfg = get_config(ARCH, smoke=True).replace(compute_dtype="float32")
    out = []
    for side in ("jax", "port"):
        mod = jft if side == "jax" else ft
        ctl = mod.FtController(
            chaos=mod.ChaosInjector(mod.ChaosSpec(**(spec or {}))),
            options=mod.FtOptions(**(options or {})))
        calls = {"n": 0}
        upd = JDetectionUpdate if side == "jax" else DetectionUpdate
        dcls = JDiagnosis if side == "jax" else Diagnosis

        def hook(events, metrics, ctl=ctl, calls=calls, upd=upd, dcls=dcls):
            calls["n"] += 1
            if on_step is not None:
                on_step(calls["n"], ctl, lambda step, **kw: upd(
                    step=step, diagnosis=_diag(dcls, **kw)))

        d = tmp_path / side
        if side == "jax":
            _, hist = jax_train(
                jcfg, JOptimizerConfig(total_steps=steps),
                JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ, global_batch=BATCH),
                JLoopConfig(n_steps=steps, log_every=1, ckpt_every=ckpt_every,
                            ckpt_dir=str(d)),
                controller=ctl, hooks=JStepHooks(on_step=hook))
        else:
            monkeypatch.setattr(tloop, "init_train_state",
                                lambda cfg, seed, device: from_jax_train_state(
                                    jstate0, device))
            _, hist = train(
                cfg, OptimizerConfig(total_steps=steps),
                DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH),
                LoopConfig(n_steps=steps, log_every=1, ckpt_every=ckpt_every,
                           ckpt_dir=str(d)),
                controller=ctl, hooks=StepHooks(on_step=hook), device="cpu")
        out += [hist, ctl]
    return out


def _assert_histories(jh, h, rtol):
    assert [r["step"] for r in h] == [r["step"] for r in jh]
    for a, b in zip(h, jh, strict=True):
        for k in ("loss", "grad_norm", "lr"):
            if math.isnan(b[k]):
                assert math.isnan(a[k]), (a["step"], k)
            else:
                assert a[k] == pytest.approx(b[k], rel=rtol), (a["step"], k)


def test_loop_crash_and_nan_rollback_equal_jax(tmp_path, jstate0, monkeypatch):
    jh, jc, h, c = _loops(tmp_path, jstate0, monkeypatch, steps=6,
                          spec=dict(crash_at_step=3, nan_at_step=4))
    _assert_histories(jh, h, HIST_RTOL)
    assert [r["step"] for r in h] == list(range(1, 7))
    assert c.report() == jc.report()
    assert [t["event"] for t in c.timeline] == ["restart", "guard:rollback", "rollback"]
    assert c.timeline[0]["details"] == {"resumed_step": 2, "reason": "InjectedCrash",
                                        "restart": 1}


def test_loop_skip_guard_equals_jax(tmp_path, jstate0, monkeypatch):
    """The skip guard discards the poisoned update without a restart: the
    port keeps a copy of the pre-step state, where JAX does not donate."""
    jh, jc, h, c = _loops(tmp_path, jstate0, monkeypatch, steps=5,
                          spec=dict(nan_at_step=2), options=dict(guard_action="skip"))
    _assert_histories(jh, h, HIST_RTOL)
    assert [r["step"] for r in h] == [1, 2, 4, 5]  # step 3's row is skipped
    assert c.report() == jc.report()
    assert c.guard_trips == 1 and c.restarts == c.rollbacks == 0


def test_loop_compression_on_equals_jax(tmp_path, jstate0, monkeypatch):
    """A degraded data link decided after step 2 switches int8 compression
    on at step 3's top on both sides; the compressed steps agree."""
    def on_step(i, ctl, update):
        if i == 2:
            ctl.on_detection(update(8, links=((0, 1),)))

    jh, jc, h, c = _loops(tmp_path, jstate0, monkeypatch, steps=6, on_step=on_step)
    _assert_histories(jh, h, COMP_RTOL)
    assert c.report() == jc.report()
    on = next(t for t in c.timeline if t["event"] == "mitigate:compress_on")
    assert on["step"] == 2 and on["details"]["links"] == [[0, 1]]
    d = on["details"]
    assert 0 < d["wire_bytes_per_sync"] < d["baseline_bytes_per_sync"]


def test_loop_without_controller_reraises(tmp_path):
    """No controller (or no ckpt_dir): a failure is not recovered."""
    cfg = get_config(ARCH, smoke=True)

    def boom(events, metrics):
        raise RuntimeError("hook failed")

    with pytest.raises(RuntimeError, match="hook failed"):
        train(cfg, OptimizerConfig(total_steps=2),
              DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH),
              LoopConfig(n_steps=2, ckpt_dir=str(tmp_path)),
              hooks=StepHooks(on_step=boom), device="cpu")
    with pytest.raises(RuntimeError, match="hook failed"):
        train(cfg, OptimizerConfig(total_steps=2),
              DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH),
              LoopConfig(n_steps=2), controller=ft.FtController(),
              hooks=StepHooks(on_step=boom), device="cpu")


# ----------------------------------------------- the CLI: guards, mitigation ---


class TestGuards:
    def test_nan_rollback_recovers_exact_trajectory(self, tmp_path):
        clean = _run(["--steps", "8", "--modules", "metrics"])
        chaotic = _run([
            "--steps", "8", "--modules", "metrics,ft",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
            "--set", "ft.chaos.nan_at_step=4",
        ])
        f = chaotic["ft"]
        assert f["guard_trips"] == 1 and f["rollbacks"] == 1
        events = [t["event"] for t in f["timeline"]]
        assert events == ["guard:rollback", "rollback"]
        assert chaotic["history"][-1]["step"] == 8
        np.testing.assert_allclose(
            chaotic["history"][-1]["loss"], clean["history"][-1]["loss"], rtol=1e-5)

    def test_nan_skip_discards_update_without_restart(self):
        res = _run([
            "--steps", "6", "--modules", "metrics,ft",
            "--set", "ft.chaos.nan_at_step=3", "--set", "ft.guard_action=skip",
        ])
        f = res["ft"]
        assert f["guard_trips"] == 1
        assert f["rollbacks"] == 0 and f["restarts"] == 0
        assert res["history"][-1]["step"] == 6
        assert math.isfinite(res["history"][-1]["loss"])

    def test_guard_off_lets_nan_poison_the_run(self):
        res = _run([
            "--steps", "5", "--modules", "metrics,ft",
            "--set", "ft.chaos.nan_at_step=2",
            "--set", "ft.guard_nan=false", "--set", "ft.guard_action=skip",
        ])
        assert res["ft"]["guard_trips"] == 0
        assert math.isnan(res["history"][-1]["loss"])


class TestMitigationExecution:
    def test_insufficient_evidence_decides_none_via_plugin(self):
        res = _run([
            "--steps", "6", "--modules", "scan,metrics,ft",
            "--detect-online", "--set", "scan.detect_every=4",
            "--set", "ft.chaos.slow_rank_from=0", "--set", "ft.chaos.slow_rank=1",
            "--set", "ft.chaos.slow_factor=0.5",
        ])
        f = res["ft"]
        assert f["detections"] >= 1
        assert not any(t["event"].startswith(("decide", "mitigate"))
                       for t in f["timeline"]), f["timeline"]
        assert f["restarts"] == 0 and f["excluded_ranks"] == []

    def test_degraded_link_switches_on_compression(self):
        res = _run([
            "--steps", "12", "--modules", "scan,metrics,ft",
            "--detect-online", "--set", "scan.detect_every=4",
            "--set", "ft.chaos.degrade_link=0-1",
        ])
        f = res["ft"]
        assert f["compression_on"] and f["replans"] == 1
        events = [t["event"] for t in f["timeline"]]
        assert "decide:replan" in events and "mitigate:compress_on" in events
        on = next(t for t in f["timeline"] if t["event"] == "mitigate:compress_on")
        d = on["details"]
        assert d["links"] == [[0, 1]]
        assert 0 < d["wire_bytes_per_sync"] < d["baseline_bytes_per_sync"]
        series = res["metrics"]["series"]
        assert 0 < series["ft.wire_bytes_compressed"] < series["ft.wire_bytes_baseline"]
        assert math.isfinite(res["history"][-1]["loss"])

    def test_hard_straggler_excluded_via_restart(self, tmp_path):
        res = _run([
            "--steps", "14", "--modules", "scan,metrics,ft",
            "--detect-online", "--set", "scan.detect_every=4",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
            "--set", "ft.chaos.slow_rank_from=0", "--set", "ft.chaos.slow_rank=1",
            "--set", "ft.chaos.slow_factor=0.5",
        ])
        f = res["ft"]
        assert f["excluded_ranks"] == [1]
        assert f["restarts"] == 1
        events = [t["event"] for t in f["timeline"]]
        for e in ("decide:exclude", "mitigate:exclude", "restart"):
            assert e in events, f["timeline"]
        assert res["history"][-1]["step"] == 14
        assert res["scan"]["online"]["first_detect_step"] <= 8


class TestChaosAcceptance:
    """A crash at step 5 and an induced straggler: the run completes all
    14 steps, ends on the fault-free final loss, and the mitigation
    timeline lands in ``results["ft"]``."""

    @pytest.fixture(scope="class")
    def runs(self, tmp_path_factory):
        d = tmp_path_factory.mktemp("ft") / "ckpt"
        clean = _run(["--steps", "14", "--modules", "metrics"])
        chaotic = _run([
            "--steps", "14", "--modules", "scan,metrics,ft",
            "--detect-online", "--set", "scan.detect_every=4",
            "--ckpt-dir", str(d), "--ckpt-every", "3",
            "--set", "ft.chaos.crash_at_step=5",
            "--set", "ft.chaos.slow_rank_from=0", "--set", "ft.chaos.slow_rank=1",
            "--set", "ft.chaos.slow_factor=0.5",
        ])
        return clean, chaotic

    def test_completes_all_steps(self, runs):
        _, chaotic = runs
        assert chaotic["history"][-1]["step"] == 14
        assert [h["step"] for h in chaotic["history"]] == list(range(1, 15))

    def test_final_loss_matches_fault_free(self, runs):
        clean, chaotic = runs
        np.testing.assert_allclose(
            chaotic["history"][-1]["loss"], clean["history"][-1]["loss"], rtol=1e-5)

    def test_timeline_records_crash_restart_and_exclusion(self, runs):
        _, chaotic = runs
        f = chaotic["ft"]
        assert f["restarts"] >= 2  # the crash + the exclusion restart
        events = [t["event"] for t in f["timeline"]]
        for e in ("restart", "decide:exclude", "mitigate:exclude"):
            assert e in events, f["timeline"]
        crash = next(t for t in f["timeline"] if t["event"] == "restart")
        assert crash["details"]["reason"] == "InjectedCrash"
        assert f["excluded_ranks"] == [1]
        assert f["detections"] > 0
        assert chaotic["scan"]["online"]["first_detect_step"] <= 8

    def test_counters_in_metrics_series(self, runs):
        _, chaotic = runs
        assert chaotic["metrics"]["series"]["ft.restarts"] >= 2


class TestCliFlags:
    def test_chaos_crash_flag(self, tmp_path):
        res = _run([
            "--steps", "6", "--modules", "metrics,ft",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--chaos-crash-at", "3", "--max-restarts", "2",
        ])
        f = res["ft"]
        assert f["restarts"] == 1
        assert f["timeline"][-1]["details"]["reason"] == "InjectedCrash"
        assert res["history"][-1]["step"] == 6

    def test_crash_without_ckpt_dir_rejected(self):
        with pytest.raises(SystemExit, match="ckpt_dir"):
            cli.main(["train", *TINY, "--steps", "4", "--modules", "ft",
                      "--set", "ft.chaos.crash_at_step=2"])

    def test_max_restarts_bounds_recovery(self, tmp_path, monkeypatch):
        # every restart re-crashes (the fired set cleared): the budget runs out
        monkeypatch.setattr(ft.ChaosInjector, "crash_due",
                            lambda self, step: step == 3)
        with pytest.raises(ft.InjectedCrash):
            _run(["--steps", "6", "--modules", "ft",
                  "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                  "--chaos-crash-at", "3", "--max-restarts", "2"])

    def test_help_names_no_refusal(self, capsys):
        with pytest.raises(SystemExit):
            cli.main(["train", "--help"])
        text = " ".join(capsys.readouterr().out.split())
        for flag in ("--detect-online", "--max-restarts", "--chaos-crash-at"):
            assert flag in text
        assert "item 9" not in text
        assert "straggler detector" in text and "bounded restarts" in text

