"""The port's MegaScan against the JAX package's: the simulated multi-rank
trace, clock alignment, straggler detection and the trace analytics give
the same results for the same seeds and inputs (both are numpy, drawn in
the same order), the chrome export is the same document, and chrome and
JSONL traces written by either package load with the other's readers.
Then every case of ``tests/test_megascan.py`` and ``tests/test_analytics.py``
runs again with its imports pointed at the port.
"""

import json
import re
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.core.tracing as jtr  # noqa: E402
from repro.core.simkit import engine as jengine  # noqa: E402
from repro.core.simkit import workload as jworkload  # noqa: E402
from repro.core.tracing import analytics as janalytics  # noqa: E402
import repro_torch.core.tracing as ttr  # noqa: E402
from repro_torch.core.simkit import engine as tengine  # noqa: E402
from repro_torch.core.simkit import workload as tworkload  # noqa: E402
from repro_torch.core.tracing import analytics as tanalytics  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

CASES = [  # (topology, faults, clocks, n_micro, n_iters)
    ((2, 2, 2), dict(compute_slowdown={5: 0.5}, jitter=0.01, seed=3),
     dict(seed=3), 4, 2),
    ((1, 4, 1), dict(link_slowdown={(1, 2): 0.25, (2, 1): 0.25}),
     dict(seed=5), 6, 1),
    ((2, 2, 2), dict(jitter=0.02, seed=11),
     dict(offset_sigma=20e-3, drift_sigma=1e-4, read_noise=1e-6, seed=7), 4, 3),
]


def _simulate(side, topo, faults, clocks, n_micro, n_iters):
    tr, eng, wl = side
    return tr.simulate_trace(
        wl.Topology(*topo), wl.ModelProfile(), n_micro=n_micro,
        n_iters=n_iters, faults=eng.FaultModel(**faults),
        clocks=tr.ClockModel(**clocks))


JAX = (jtr, jengine, jworkload)
PORT = (ttr, tengine, tworkload)


def _rows(events):
    return [e.to_json() for e in events]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_simulate_align_detect_equal_jax(case):
    topo, faults, clocks, n_micro, n_iters = CASES[case]
    jev, jtruth = _simulate(JAX, *CASES[case])
    tev, ttruth = _simulate(PORT, *CASES[case])
    assert _rows(tev) == _rows(jev)
    assert ttruth == jtruth
    jal, tal = jtr.align_clocks(jev), ttr.align_clocks(tev)
    assert tal.linear == jal.linear
    assert tal.anchors.keys() == jal.anchors.keys()
    for r in jal.anchors:
        np.testing.assert_array_equal(tal.anchors[r], jal.anchors[r])
    jaligned = jtr.apply_alignment(jev, jal)
    taligned = ttr.apply_alignment(tev, tal)
    assert _rows(taligned) == _rows(jaligned)
    jdiag = jtr.detect(jaligned, jworkload.Topology(*topo))
    tdiag = ttr.detect(taligned, tworkload.Topology(*topo))
    assert tdiag.summary() == jdiag.summary()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_analytics_equal_jax(case):
    jev, _ = _simulate(JAX, *CASES[case])
    tev, _ = _simulate(PORT, *CASES[case])
    jt, tt = janalytics.to_table(jev), tanalytics.to_table(tev)
    assert tanalytics.bandwidth_by_edge(tt) == janalytics.bandwidth_by_edge(jt)
    assert tanalytics.utilization_by_rank(tt) == janalytics.utilization_by_rank(jt)
    assert tanalytics.slow_ops(tt, ratio=1.5) == janalytics.slow_ops(jt, ratio=1.5)
    assert tanalytics.iteration_breakdown(tt) == janalytics.iteration_breakdown(jt)


def _with_counters(side, events):
    tr = side[0]
    out = list(events[:40])
    out.append(tr.TraceEvent("train.loss", 0, 1.5, 0.0, "counter", {"value": 2.0}))
    out.append(tr.TraceEvent("mark", 1, 1.6, 0.0, "marker", {"why": "x"}))
    return out


def test_chrome_documents_equal_and_cross_load(tmp_path):
    jev = _with_counters(JAX, _simulate(JAX, *CASES[0])[0])
    tev = _with_counters(PORT, _simulate(PORT, *CASES[0])[0])
    from repro.core.tracing.chrome import save_chrome as jsave
    from repro_torch.core.tracing.chrome import save_chrome as tsave

    assert ttr.to_chrome(tev) == jtr.to_chrome(jev)
    jsave(jev, tmp_path / "j.json")
    tsave(tev, tmp_path / "t.json")
    assert (tmp_path / "j.json").read_text() == (tmp_path / "t.json").read_text()
    for path in ("j.json", "t.json"):
        doc = json.loads((tmp_path / path).read_text())
        assert _rows(ttr.from_chrome(doc)) == _rows(jtr.from_chrome(doc))
        assert _rows(ttr.load_trace(tmp_path / path)) == _rows(jtr.load_trace(tmp_path / path))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_jsonl_streams_cross_load(tmp_path, writer):
    side = JAX if writer == "jax" else PORT
    events = _simulate(side, *CASES[1])[0][:50]
    w = side[0].AsyncTraceWriter(tmp_path / "s.jsonl", mode="w")
    w.submit(events)
    w.close()
    for reader in (jtr, ttr):
        assert _rows(reader.load_jsonl(tmp_path / "s.jsonl")) == _rows(events)
        assert _rows(reader.load_trace(tmp_path / "s.jsonl")) == _rows(events)


def test_tracer_record_instant_and_gather_equal_jax():
    def drive(tr):
        clock = iter(np.arange(0.0, 10.0, 0.5)).__next__
        a, b = tr.Tracer(rank=0, clock=clock), tr.Tracer(rank=1, clock=clock)
        with a.scope("fwd", mb=0):
            pass
        b.record("allreduce", 0.25, 1.0, "coll", group=(0, 1))
        a.instant("diagnosis", slow_ranks=[1])
        return _rows(tr.gather_traces([a, b]))

    assert drive(ttr) == drive(jtr)


def _port_module(name: str) -> types.ModuleType:
    """``tests/<name>.py`` executed with its ``repro.`` imports pointed at
    ``repro_torch.``: the reference's own cases, run on the port."""
    path = ROOT / "tests" / f"{name}.py"
    src = re.sub(r"^(\s*)from repro\.", r"\1from repro_torch.",
                 path.read_text(), flags=re.M)
    assert "repro." not in re.sub(r"repro_torch\.", "", src)
    mod = types.ModuleType(f"port_{name}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


for _name in ("test_megascan", "test_analytics"):
    for _k, _v in vars(_port_module(_name)).items():
        if _k.startswith("test_") and callable(_v):
            globals()[f"test_port_{_name[5:]}_{_k[5:]}"] = _v
del _name, _k, _v
