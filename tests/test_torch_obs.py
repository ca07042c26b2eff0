"""The port's metrics registry and exporters against ``repro.obs``: after
the same observations, ``snapshot()``, ``flatten_snapshot``,
``prometheus_text`` and ``counter_events`` are equal (the P² quantiles
included, which are float arithmetic in the same order), and the JSONL
exporter, which writes on a thread of its own in the port, leaves the same
rows on disk."""

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402


def _observe(obs, seed):
    rng = np.random.default_rng(seed)
    reg = obs.MetricsRegistry()
    for i in range(200):
        reg.counter("serve.tokens").inc(int(rng.integers(0, 9)))
        reg.gauge("serve.queue_depth").set(float(rng.integers(0, 5)))
        reg.histogram("train.step_time_s").observe(float(rng.lognormal(-3, 0.5)))
        if i % 3 == 0:
            reg.histogram("serve.ttft_s").observe(float(rng.exponential(0.2)))
    reg.histogram("serve.empty_s")  # a histogram with no observation yet
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_and_exports_equal_jax(seed):
    jreg, treg = _observe(jobs, seed), _observe(tobs, seed)
    jsnap, tsnap = jreg.snapshot(), treg.snapshot()
    assert tsnap == jsnap
    assert tobs.flatten_snapshot(tsnap) == jobs.flatten_snapshot(jsnap)
    assert tobs.prometheus_text(treg) == jobs.prometheus_text(jreg)
    assert ([e.to_json() for e in tobs.counter_events(tsnap, ts=1.25, rank=3)]
            == [e.to_json() for e in jobs.counter_events(jsnap, ts=1.25, rank=3)])
    assert len(treg) == len(jreg) and "serve.ttft_s" in treg
    assert treg.kind_of("serve.tokens") == jreg.kind_of("serve.tokens")


@pytest.mark.parametrize("q", [0.5, 0.95, 0.99])
def test_p2_quantile_equal_jax(q):
    rng = np.random.default_rng(7)
    jq, tq = jobs.P2Quantile(q), tobs.P2Quantile(q)
    for n, x in enumerate(rng.standard_normal(500)):
        jq.observe(x)
        tq.observe(x)
        if n in (0, 3, 4, 5, 99, 499):
            assert tq.value == jq.value


def test_registry_guards_equal_jax():
    for obs in (jobs, tobs):
        reg = obs.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError):
            reg.gauge("x")
        with pytest.raises(ValueError):
            reg.counter("y").inc(-1)
        with pytest.raises(ValueError):
            obs.P2Quantile(1.0)


def test_jsonl_exporter_rows_equal_jax(tmp_path):
    rows = [{"step": i, "ts": 0.5 * i, "train.loss": 1.0 / (i + 1)} for i in range(50)]
    paths = []
    for name, obs in (("j", jobs), ("t", tobs)):
        ex = obs.JsonlExporter(tmp_path / name / "m.jsonl")
        for r in rows:
            ex.write(dict(r))
        ex.close()
        ex.close()  # closing twice is harmless on both sides
        assert ex.rows == len(rows)
        paths.append(ex.path)
    assert paths[1].read_text() == paths[0].read_text()
