"""Live straggler detection on the port (``repro_torch.obs.inject``,
``repro_torch.obs.detector``, the ``scan`` plugin's ``--detect-online``)
held to the JAX package's ``repro.obs`` on the CPU: ``emit_rank_events``
gives JAX's ``TraceEvent``s (name, rank, ts, dur, kind, args) for the same
window, and ``OnlineDetector`` gives JAX's updates and history on the same
event streams, drawn from a seeded numpy generator.  Then
``tests/test_obs.py``'s ``TestLiveStragglerAcceptance`` on the port's own
``Session``, with its assertions (the JAX class fails through ``Session``
on this tree, ROADMAP R3)."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core.tracing.events import TraceEvent as JTraceEvent  # noqa: E402
from repro.obs import OnlineDetector as JOnlineDetector  # noqa: E402
from repro.obs import RankEventSpec as JRankEventSpec  # noqa: E402
from repro.obs import emit_rank_events as jemit  # noqa: E402
from repro_torch.app import cli  # noqa: E402
from repro_torch.core.simkit.workload import Topology  # noqa: E402
from repro_torch.core.tracing import load_jsonl  # noqa: E402
from repro_torch.core.tracing.events import TraceEvent  # noqa: E402
from repro_torch.obs import OnlineDetector, RankEventSpec, emit_rank_events  # noqa: E402

SPECS = [
    dict(dp=2),
    dict(dp=2, slow_rank=1, slow_factor=0.5),
    dict(dp=4, pp=2, slow_rank=5, slow_factor=0.3),
    dict(dp=2, tp=2, degrade_link=(0, 1), degrade_factor=0.25),
    dict(dp=1, pp=3, degrade_link=(2, 0), degrade_factor=0.5),
]


def _fields(e) -> tuple:
    return (e.name, e.rank, e.ts, e.dur, e.kind, e.args)


def _stream(rng, spec_kw: dict, steps: int, *, slow_from: int = 0,
            heal_at: int | None = None):
    """The same per-step windows through both ``emit_rank_events``: walls
    drawn from ``rng``, the straggler's share of each (``extra``) from
    ``slow_from`` on and, from ``heal_at``, a healthy spec."""
    ts, out = 0.0, []
    for step in range(steps):
        wall = float(rng.uniform(0.05, 0.3))
        kw = dict(spec_kw)
        if heal_at is not None and step >= heal_at:
            kw.pop("slow_rank", None)
        slow = kw.get("slow_rank", -1) >= 0 and step >= slow_from
        extra = float(rng.uniform(0.3, 0.6)) * wall if slow else 0.0
        ours, theirs = [], []
        emit_rank_events(ours, RankEventSpec(**kw), ts=ts, wall=wall, extra=extra,
                         step=step)
        jemit(theirs, JRankEventSpec(**kw), ts=ts, wall=wall, extra=extra, step=step)
        out.append((ours, theirs))
        ts += wall + float(rng.uniform(0.0, 0.01))
    return out


@pytest.mark.parametrize("spec_kw", SPECS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_emit_rank_events_equal_jax(spec_kw):
    rng = np.random.default_rng(0)
    for ours, theirs in _stream(rng, spec_kw, steps=4):
        assert [_fields(e) for e in ours] == [_fields(e) for e in theirs]
    a, b = RankEventSpec(**spec_kw), JRankEventSpec(**spec_kw)
    assert a.world == b.world
    assert vars(a.topology()) == vars(b.topology())
    for base in (0.0, 0.1, 2.5):
        assert a.extra_seconds(base) == b.extra_seconds(base)


@pytest.mark.parametrize("case", [
    dict(spec=dict(dp=2, slow_rank=1, slow_factor=0.5), steps=16, every=4, window=16),
    dict(spec=dict(dp=2), steps=12, every=4, window=16),
    dict(spec=dict(dp=2, slow_rank=1, slow_factor=0.5), steps=16, every=4, window=4,
         heal_at=8),
    dict(spec=dict(dp=4, pp=2, slow_rank=5, slow_factor=0.3), steps=12, every=3,
         window=8, align=True),
    dict(spec=dict(dp=2, tp=2, degrade_link=(0, 1)), steps=12, every=4, window=8),
    dict(spec=dict(dp=2, slow_rank=0), steps=10, every=2, window=6, slow_from=4,
         thresholds=dict(slow_ratio=1.1, late_frac=0.3)),
], ids=["slow", "healthy", "recovery", "dp4-pp2-aligned", "link", "late-thresholds"])
def test_online_detector_equals_jax(case):
    """Every pass's diagnosis, deltas and step, and the history, equal JAX's
    on the same seeded stream (the port's events go to the port's
    detector, JAX's to JAX's)."""
    rng = np.random.default_rng(1)
    spec = RankEventSpec(**case["spec"])
    kw = dict(every=case["every"], window=case["window"],
              align=case.get("align", False), thresholds=case.get("thresholds"))
    ours = OnlineDetector(spec.topology(), **kw)
    theirs = JOnlineDetector(JRankEventSpec(**case["spec"]).topology(), **kw)
    n_updates = 0
    for a, b in _stream(rng, case["spec"], case["steps"], heal_at=case.get("heal_at"),
                        slow_from=case.get("slow_from", 0)):
        ua, ub = ours.push(a), theirs.push(b)
        assert (ua is None) == (ub is None)
        if ua is None:
            continue
        n_updates += 1
        assert ua.step == ub.step
        assert ua.diagnosis.summary() == ub.diagnosis.summary()
        assert ua.diagnosis.evidence == ub.diagnosis.evidence
        assert ua.diagnosis.link_bandwidth == ub.diagnosis.link_bandwidth
        assert (ua.new_slow_ranks, ua.cleared_slow_ranks, ua.new_degraded_links,
                ua.changed) == (ub.new_slow_ranks, ub.cleared_slow_ranks,
                                ub.new_degraded_links, ub.changed)
    assert n_updates == len(theirs.history) >= case["steps"] // case["every"] - 1
    assert ours.history == theirs.history


def test_online_detector_outcomes():
    """``tests/test_obs.py``'s streaming outcomes on the port: the slow rank
    named on the first pass and steady after, no false positive on a
    healthy run, a recovery cleared once the window rolls over."""
    slow = RankEventSpec(dp=2, slow_rank=1, slow_factor=0.5)
    det = OnlineDetector(slow.topology(), every=4, window=16)
    updates = []
    for step in range(8):
        evs = []
        emit_rank_events(evs, slow, ts=step * 0.2, wall=0.2, extra=0.1, step=step)
        if (u := det.push(evs)) is not None:
            updates.append(u)
    assert updates[0].diagnosis.slow_ranks == [1]
    assert updates[0].new_slow_ranks == [1] and updates[0].changed
    assert all(not u.changed for u in updates[1:])
    healthy = RankEventSpec(dp=2)
    det = OnlineDetector(healthy.topology(), every=4, window=4)
    for step in range(4):
        evs = []
        emit_rank_events(evs, slow, ts=step * 0.2, wall=0.2, extra=0.1, step=step)
        det.push(evs)
    assert det.history[-1]["slow_ranks"] == [1]
    for step in range(4, 8):
        evs = []
        emit_rank_events(evs, healthy, ts=step * 0.2, wall=0.2, step=step)
        u = det.push(evs)
    assert u.cleared_slow_ranks == [1] and u.diagnosis.slow_ranks == []


def test_online_detector_guards():
    topo = Topology(dp=2, pp=1, tp=1)
    with pytest.raises(ValueError):
        OnlineDetector(topo, every=0)
    with pytest.raises(ValueError):
        OnlineDetector(topo, window=0)
    det = OnlineDetector(topo, every=1, min_events=10_000)
    assert det.push([TraceEvent("x", 0, 0.0, 1.0, "compute", {})]) is None
    # markers and counters are not analysed
    det = OnlineDetector(topo, every=1, min_events=1)
    assert det.push([TraceEvent("m", 0, 0.0, 0.0, "marker", {})]) is None
    jdet = JOnlineDetector(topo, every=1, min_events=1)
    assert jdet.push([JTraceEvent("m", 0, 0.0, 0.0, "marker", {})]) is None


# ------------------------------------------------ acceptance: live detect ---


class TestLiveStragglerAcceptance:
    """A train run with an induced straggler names that rank while it runs,
    its metrics render as chrome counter tracks, and the streamed sidecar
    supports offline re-detection (``tests/test_obs.py``'s class, on the
    port's ``Session``)."""

    @pytest.fixture(scope="class")
    def live_run(self, tmp_path_factory):
        from repro_torch.app.config import build_run_config
        from repro_torch.app.session import Session

        out = tmp_path_factory.mktemp("obs") / "trace.json"
        cfg = build_run_config(
            "train",
            sets=["obs.slow_rank=1", "obs.dp=2", "obs.slow_factor=0.5",
                  "scan.detect_online=true", "scan.detect_every=4",
                  "train.steps=12", "train.seq_len=32",
                  "train.global_batch=2", "obs.peak_tflops=0.001",
                  "runtime.device=cpu"],
            arch="qwen2-0.5b", smoke=True, trace_out=str(out),
        )
        session = Session(cfg)
        session.run()
        return session, out

    def test_online_diagnosis_names_slow_rank_during_run(self, live_run):
        session, _ = live_run
        online = session.results["scan"]["online"]
        assert online["slow_ranks"] == [1]
        assert online["first_detect_step"] is not None
        assert online["first_detect_step"] <= 8
        assert online["passes"] >= 2

    def test_diagnosis_instant_event_in_trace(self, live_run):
        _, out = live_run
        doc = json.loads(out.read_text())
        marks = [e for e in doc["traceEvents"]
                 if e.get("ph") == "i" and e["name"] == "diagnosis"]
        assert marks and marks[0]["args"]["slow_ranks"] == [1]
        assert marks[0]["args"]["new"] == [1]

    def test_metrics_render_as_counter_tracks(self, live_run):
        _, out = live_run
        doc = json.loads(out.read_text())
        counters = [e for e in doc["traceEvents"] if e.get("ph") == "C"]
        names = {e["name"] for e in counters}
        assert "train.loss" in names
        assert "train.step_time_s.p50" in names
        assert all("value" in e["args"] for e in counters)

    def test_mfu_estimate_reported(self, live_run):
        session, _ = live_run
        assert session.results["metrics"].get("mfu_est", 0) > 0

    def test_streamed_sidecar_redetects_offline(self, live_run):
        session, out = live_run
        side = out.with_suffix(".jsonl")
        assert str(side) == session.results["scan"]["stream"]
        assert side.exists() and len(load_jsonl(side)) > 0
        res = cli.run(["trace", "--detect", str(side),
                       "--dp", "2", "--pp", "1", "--tp", "1"])
        assert res["diagnosis"]["slow_ranks"] == [1]

    def test_rank_events_in_the_trace(self, live_run):
        """Each step's synthesized per-rank events: fwd, bwd and the
        gradient all-reduce on ranks 0 and 1, the slow rank's all-reduce
        starting late inside the step's span."""
        session, _ = live_run
        evs = session.tracer.events
        steps = [e for e in evs if e.name == "train_step"]
        assert len(steps) == 12
        for name in ("fwd", "bwd", "allreduce_grads"):
            assert sorted({e.rank for e in evs if e.name == name}) == [0, 1]
            assert sum(e.name == name for e in evs) == 24
        ar = {e.rank: e for e in evs if e.name == "allreduce_grads"
              and e.args["mb"] == 11}
        assert ar[1].ts > ar[0].ts
        assert ar[0].end == pytest.approx(steps[-1].end)
