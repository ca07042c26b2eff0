"""The port's MegaRoute against ``repro.serve.router`` and the serving half of
``repro.core.simkit.workload``, on the CPU.

The traffic generators, the offline evaluators (``serving_workload``,
``router_workload``, ``router_summary``), placement and SLO admission must
equal JAX's exactly (floats within 1e-12).  The live ``Router`` runs the
smoke qwen2-0.5b at float32 (``attn_kv_chunk=4096``, as
``tests/test_router.py`` sets it) over two replicas: its greedy streams must
equal JAX ``Router``'s and JAX's single ``MegaServe``'s for every placement
policy, a disaggregated fleet (prefill replica -> decode replica slot
migration), a thinned replica and SLO shedding.  Both routers read one
injected clock, ``router.tick * 1e-3``, so placement (which reads live
queues) and every timing field are deterministic, and ``metrics()`` must
equal JAX's key for key.  Slot export/import bundles equal JAX's bit for
bit on a qwen2 pool (paged leaves) and a recurrentgemma pool (paged and
slot-state leaves).
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.simkit import workload as jwl  # noqa: E402
from repro.core.simkit.engine import Engine as JEngine  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import MegaServe as JaxMegaServe  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import Router as JRouter  # noqa: E402
from repro.serve import RouterConfig as JRouterConfig  # noqa: E402
from repro.serve import Scheduler as JScheduler  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve.paged_cache import PagedKVCache as JPagedKVCache  # noqa: E402
from repro.serve.paged_cache import PoolSpec as JPoolSpec  # noqa: E402
from repro.serve.server import make_poisson_workload as jax_workload  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.simkit import workload as wl  # noqa: E402
from repro_torch.core.simkit.engine import Engine  # noqa: E402
from repro_torch.models.weights import from_jax_params  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    PagedKVCache,
    PoolSpec,
    Request,
    Router,
    RouterConfig,
    Scheduler,
    ServeConfig,
)
from repro_torch.serve.server import MegaServe, make_poisson_workload  # noqa: E402

FLOAT_TOL = 1e-12
GEOM = dict(num_slots=3, block_size=8, num_blocks=40, max_blocks_per_slot=8)


def _equal(ours, ref, where=""):
    """Exact for everything but floats, which agree within ``FLOAT_TOL``."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and set(ours) == set(ref), where
        for k in ref:
            _equal(ours[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref), where
        for i, (a, b) in enumerate(zip(ours, ref)):
            _equal(a, b, f"{where}[{i}]")
    elif isinstance(ref, float):
        assert abs(ours - ref) <= FLOAT_TOL, (where, ours, ref)
    else:
        assert ours == ref, (where, ours, ref)


def _specs(specs):
    return [dataclasses.astuple(s) for s in specs]


def _tasks(tasks: dict) -> dict:
    return {r: [dataclasses.asdict(t) for t in ts] for r, ts in tasks.items()}


# ------------------------------------------------------ traffic generators


@pytest.mark.parametrize("seed", [0, 5, 11])
@pytest.mark.parametrize("gen,kw", [
    ("poisson_requests", {}),
    ("bursty_requests", {}),
    ("bursty_requests", dict(burst_mult=10.0, burst_frac=0.3, burst_dwell_s=0.05)),
    ("diurnal_requests", {}),
    ("diurnal_requests", dict(period_s=2.0, depth=1.0)),
])
def test_traffic_generators_equal_jax(gen, kw, seed):
    args = dict(prompt_lens=(16, 32, 256), max_new_range=(2, 30), seed=seed, **kw)
    ours = getattr(wl, gen)(120, 35.0, **args)
    ref = getattr(jwl, gen)(120, 35.0, **args)
    assert len(ours) == 120
    assert _specs(ours) == _specs(ref)


@pytest.mark.parametrize("gen,kw", [
    ("bursty_requests", dict(burst_mult=1.0)),
    ("bursty_requests", dict(burst_frac=0.0)),
    ("bursty_requests", dict(burst_frac=1.5)),
    ("diurnal_requests", dict(depth=0.0)),
    ("diurnal_requests", dict(depth=1.2)),
])
def test_traffic_generators_refuse_what_jax_refuses(gen, kw):
    with pytest.raises(ValueError):
        getattr(jwl, gen)(10, 10.0, **kw)
    with pytest.raises(ValueError):
        getattr(wl, gen)(10, 10.0, **kw)


@pytest.mark.parametrize("traffic", ["poisson", "bursty", "diurnal"])
def test_make_poisson_workload_traffic_equals_jax(traffic):
    kw = dict(n=16, rate=50.0, prompt_lens=(16, 32), max_new_range=(2, 8),
              num_slots=2, seed=3, traffic=traffic)
    js, jp, jc = jax_workload(jax_get_config("qwen2-0.5b", smoke=True), **kw)
    ts, tp, tc = make_poisson_workload(get_config("qwen2-0.5b", smoke=True), **kw)
    assert _specs(ts) == _specs(js)
    assert tp == jp
    assert (tc.num_blocks, tc.max_blocks_per_slot) == (jc.num_blocks,
                                                       jc.max_blocks_per_slot)
    with pytest.raises(ValueError, match="unknown traffic"):
        make_poisson_workload(get_config("qwen2-0.5b", smoke=True),
                              **{**kw, "traffic": "weekly"})


# ------------------------------------------------------ offline evaluators


@pytest.mark.parametrize("policy,kw", [
    ("continuous", dict(num_slots=3)),
    ("continuous", dict(num_slots=1)),
    ("static", dict(num_slots=3)),
    ("static", dict(num_slots=2, batch_size=4)),
])
def test_serving_workload_equals_jax(policy, kw):
    reqs = wl.bursty_requests(40, 60.0, prompt_lens=(16, 32, 64),
                              max_new_range=(1, 12), seed=2)
    jreqs = jwl.bursty_requests(40, 60.0, prompt_lens=(16, 32, 64),
                                max_new_range=(1, 12), seed=2)
    ours = wl.serving_workload(reqs, policy=policy, **kw)
    ref = jwl.serving_workload(jreqs, policy=policy, **kw)
    assert _tasks(ours) == _tasks(ref)
    _equal(wl.serving_throughput(Engine().run(ours)),
           jwl.serving_throughput(JEngine().run(ref)))
    with pytest.raises(ValueError):
        wl.serving_workload(reqs, policy="lifo")


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("policy,kw", [
    ("round_robin", {}),
    ("least_kv", {}),
    ("jsq", {}),
    ("jsq", dict(replica_speeds=(1.0, 0.35))),
    ("round_robin", dict(replica_speeds=(1.0, 0.35), n_replicas=2)),
    ("least_kv", dict(n_replicas=3, kv_capacity_tokens=300)),
    ("jsq", dict(slo_ttft_s=0.02)),
    ("round_robin", dict(slo_ttft_s=0.02, shed=False)),
    ("jsq", dict(slo_ttft_s=1e-9)),
])
def test_router_workload_and_summary_equal_jax(policy, kw, seed):
    args = dict(prompt_lens=(16, 32, 256), max_new_range=(4, 48), seed=seed)
    reqs = wl.bursty_requests(60, 40.0, **args)
    jreqs = jwl.bursty_requests(60, 40.0, **args)
    kw = {"n_replicas": 2, "num_slots": 4, "kv_capacity_tokens": 600, **kw}
    ours = wl.router_workload(reqs, policy=policy, **kw)
    ref = jwl.router_workload(jreqs, policy=policy, **kw)
    assert _tasks(ours) == _tasks(ref)
    summ = wl.router_summary(Engine().run(ours), n_replicas=kw["n_replicas"])
    _equal(summ, jwl.router_summary(JEngine().run(ref), n_replicas=kw["n_replicas"]))
    assert summ["conserved"] and summ["submitted"] == 60


def test_router_workload_refuses_what_jax_refuses():
    reqs = wl.poisson_requests(8, 10.0, seed=0)
    for kw in (dict(n_replicas=0), dict(policy="warmest", n_replicas=2),
               dict(n_replicas=2, replica_speeds=(1.0,))):
        with pytest.raises(ValueError):
            wl.router_workload(reqs, **kw)
        with pytest.raises(ValueError):
            jwl.router_workload(jwl.poisson_requests(8, 10.0, seed=0), **kw)


def _views(rng, n):
    out = []
    for _ in range(n):
        out.append(dict(queued=int(rng.integers(0, 6)),
                        queued_prefill_tokens=int(rng.integers(0, 900)),
                        active=int(rng.integers(0, 5)),
                        kv_used_frac=float(rng.choice([0.0, 0.25, 0.5, rng.uniform()]))))
    return out


@pytest.mark.parametrize("policy", ["round_robin", "least_kv", "jsq"])
def test_place_and_admission_decision_equal_jax(policy):
    rng = np.random.default_rng(9)
    prof = dict(prefill_time_per_token=40e-6, decode_step_base=3e-3,
                decode_step_per_seq=0.3e-3)
    for trial in range(200):
        raw = _views(rng, int(rng.integers(1, 5)))
        views = [wl.PlacementView(**v) for v in raw]
        jviews = [jwl.PlacementView(**v) for v in raw]
        rr = int(rng.integers(0, 9))
        assert wl.place(policy, views, rr) == jwl.place(policy, jviews, rr)
        plen = int(rng.integers(1, 2048))
        slo = float(rng.choice([0.0, 1e-12, 0.01, 0.05, 0.2]))
        shed = bool(trial % 2)
        for p, jp in ((wl.ServeProfile(), jwl.ServeProfile()),
                      (wl.ServeProfile(**prof), jwl.ServeProfile(**prof))):
            _equal(wl.estimate_ttft(views[0], plen, p),
                   jwl.estimate_ttft(jviews[0], plen, jp))
            _equal(list(wl.admission_decision(policy, views, plen, prof=p, rr=rr,
                                              slo_ttft_s=slo, shed=shed)),
                   list(jwl.admission_decision(policy, jviews, plen, prof=jp, rr=rr,
                                               slo_ttft_s=slo, shed=shed)))
    with pytest.raises(ValueError):
        wl.place("warmest", views)


def test_serve_profile_constants_are_jax_s():
    assert dataclasses.astuple(wl.ServeProfile()) == dataclasses.astuple(jwl.ServeProfile())


# --------------------------------------------------- scheduler migration


def _scheds(num_slots=2):
    kw = dict(num_slots=num_slots, num_blocks=9, block_size=8, max_blocks_per_slot=4)
    return Scheduler(ServeConfig(**kw)), JScheduler(JaxServeConfig(**kw))


def _state(s):
    return (list(s.slots), [list(b) for b in s.blocks], list(s.pos),
            list(s.last_tok), s.tables.tolist(), s.allocator.num_free,
            sorted(s.requests))


def test_scheduler_adopt_and_release_equal_jax():
    s, js = _scheds()
    got = s.adopt(Request(rid=7, prompt=list(range(10)), max_new=4), pos=10, last_tok=3)
    ref = js.adopt(JRequest(rid=7, prompt=list(range(10)), max_new=4), pos=10, last_tok=3)
    assert got == ref and len(got[1]) == 2
    got = s.adopt(Request(rid=2, prompt=[1] * 20, max_new=4), pos=20, last_tok=9)
    ref = js.adopt(JRequest(rid=2, prompt=[1] * 20, max_new=4), pos=20, last_tok=9)
    assert got == ref
    assert _state(s) == _state(js)
    assert s.requests[7].status.name == js.requests[7].status.name == "RUNNING"
    with pytest.raises(ValueError):
        s.adopt(Request(rid=7, prompt=[1], max_new=2), pos=1, last_tok=1)
    s.release_request(7)
    js.release_request(7)
    assert _state(s) == _state(js)
    assert 7 not in s.requests
    with pytest.raises(ValueError):
        s.release_request(7)
    s.release_request(2)
    assert s.allocator.num_held == 0 and s.active_slots() == []


def test_scheduler_adopt_returns_none_when_full():
    s, js = _scheds(num_slots=1)
    for sched, R in ((s, Request), (js, JRequest)):
        assert sched.adopt(R(rid=0, prompt=[1] * 8, max_new=2), 8, 1) is not None
        assert sched.adopt(R(rid=1, prompt=[1] * 8, max_new=2), 8, 1) is None
    # a slot is free but no block is: nothing is claimed
    s, js = _scheds(num_slots=3)
    for sched, R in ((s, Request), (js, JRequest)):
        assert sched.adopt(R(rid=0, prompt=[1] * 32, max_new=2), 32, 1) is not None
        assert sched.adopt(R(rid=1, prompt=[1] * 32, max_new=2), 32, 1) is not None
        assert sched.adopt(R(rid=2, prompt=[1] * 8, max_new=2), 8, 1) is None
    assert _state(s) == _state(js)
    assert s.slots[2] is None and s.allocator.num_free == 0


# ------------------------------------------------------ slot export/import


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _fill(rng, kv, jkv):
    """The same random values in both pools, each leaf in its own dtype."""
    vals = {p: rng.standard_normal(tuple(t.shape)).astype(np.float32)
            for p, t in _flat(kv.pool)}
    pool = {p: torch.from_numpy(v).to(t.dtype) for (p, t), v in
            zip(_flat(kv.pool), vals.values())}
    jpool = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(vals["/".join(k.key for k in path)]).astype(a.dtype),
        jkv.pool)
    return _nest(pool), jpool


def _nest(flat):
    out = {}
    for path, v in flat.items():
        d = out
        *heads, last = path.split("/")
        for h in heads:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-9b"])
def test_export_import_bundles_equal_jax(arch):
    """Export slot 1's blocks [3, 5] (padded with the null block), import
    them at blocks [7, 2] and slot 0 of a second pool, export back: every
    bundle equals JAX's bit for bit, the second pool equals JAX's (the null
    block's duplicate writes aside) and the round trip is exact."""
    spec = dict(num_slots=2, num_blocks=9, block_size=8, max_blocks=4)
    jcfg = jax_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    jkv = JPagedKVCache(jcfg, JPoolSpec(**spec))
    kv = PagedKVCache(cfg, PoolSpec(**spec), torch.device("cpu"))
    paged = dict(_flat(kv.paged))
    assert kv.paged == jkv.paged
    if arch == "recurrentgemma-9b":
        assert set(paged.values()) == {True, False}
    rng = np.random.default_rng(3)
    pool, jpool = _fill(rng, kv, jkv)
    pool2, jpool2 = _fill(rng, kv, jkv)
    phys, phys2 = [3, 5, 0, 0], [7, 2, 0, 0]

    bundle = kv.export_slot(pool, torch.tensor(phys, dtype=torch.int32), 1)
    jbundle = jkv.export_slot(jpool, jnp.asarray(phys, jnp.int32), jnp.int32(1))
    ours = dict(_flat(bundle))
    for path, leaf in _flat(jbundle):
        assert ours[path].dtype == dict(_flat(pool))[path].dtype
        np.testing.assert_array_equal(_np(ours[path]), _np(leaf), err_msg=path)
    # a copy: writing the pool afterwards leaves the bundle as it was
    before = {p: t.clone() for p, t in ours.items()}
    for _, t in _flat(pool):
        t.zero_()
    assert all(torch.equal(before[p], t) for p, t in _flat(bundle))

    kv.import_slot(pool2, bundle, torch.tensor(phys2, dtype=torch.int32), 0)
    jpool2 = jkv.import_slot(jpool2, jbundle, jnp.asarray(phys2, jnp.int32),
                             jnp.int32(0))
    got2 = dict(_flat(pool2))
    for path, leaf in _flat(jpool2):
        a, b = _np(got2[path]), _np(leaf)
        if paged[path]:
            a, b = a[:, 1:], b[:, 1:]
        np.testing.assert_array_equal(a, b, err_msg=path)
    back = kv.export_slot(pool2, torch.tensor(phys2, dtype=torch.int32), 0)
    for path, t in _flat(back):
        ref = before[path]
        if paged[path]:
            t, ref = t[:, :2], ref[:, :2]
        assert torch.equal(t, ref), path


# --------------------------------------------------------- RouterConfig


@pytest.mark.parametrize("kw", [
    dict(replicas=0), dict(policy="warmest"),
    dict(replicas=2, prefill_replicas=2), dict(replicas=2, prefill_replicas=-1),
    dict(slo_ttft_s=-1.0),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_router_config_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as ours:
        RouterConfig(**kw)
    with pytest.raises(ValueError) as ref:
        JRouterConfig(**kw)
    assert str(ours.value) == str(ref.value)


def test_router_config_defaults_and_disaggregated_equal_jax():
    assert dataclasses.asdict(RouterConfig()) == dataclasses.asdict(JRouterConfig())
    assert RouterConfig(replicas=3, prefill_replicas=1).disaggregated
    assert not RouterConfig(replicas=3).disaggregated


# --------------------------------------------------------- the live router


@pytest.fixture(scope="module")
def qwen():
    jcfg = jax_get_config("qwen2-0.5b", smoke=True).replace(
        compute_dtype="float32", attn_kv_chunk=4096)
    cfg = get_config("qwen2-0.5b", smoke=True).replace(
        compute_dtype="float32", attn_kv_chunk=4096)
    params = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, params


def _requests(seed, n, vocab, lo=4, hi=20, new_lo=3, new_hi=9):
    """As ``tests/test_router.py`` draws them."""
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(2, vocab, size=int(rng.integers(lo, hi))).tolist(),
         int(rng.integers(new_lo, new_hi)), i * 0.001)
        for i in range(n)
    ]


@pytest.fixture(scope="module")
def single(qwen):
    """JAX's single ``MegaServe`` streams for request seeds 0 and 1."""
    jcfg, cfg, params = qwen
    out = {}
    for seed in (0, 1):
        srv = JaxMegaServe(jcfg, jax.tree.map(jnp.asarray, params),
                           JaxServeConfig(**GEOM))
        for p, mn, a in _requests(seed, 8, cfg.vocab_size):
            srv.submit(p, mn, arrival=a)
        out[seed] = srv.drain()
    return out


def _tick_clock():
    """``router.tick * 1e-3`` of the router it is bound to (0 until then)."""
    box = {}

    def clock():
        return box["r"].tick * 1e-3 if "r" in box else 0.0

    return box, clock


def _route(make, reqs):
    box, clock = _tick_clock()
    router = make(clock)
    box["r"] = router
    for p, mn, a in reqs:
        router.submit(p, mn, arrival=a)
    return router.drain(), router


ROUTED = {
    "round_robin": (0, dict(replicas=2, policy="round_robin"), {}),
    "least_kv": (0, dict(replicas=2, policy="least_kv"), {}),
    "jsq": (0, dict(replicas=2, policy="jsq"), {}),
    "disaggregated": (1, dict(replicas=2, prefill_replicas=1), {}),
    "thinned": (0, dict(replicas=2, policy="least_kv"),
                dict(replica_step_every=[1, 3])),
    "shed": (2, dict(replicas=2, policy="jsq", slo_ttft_s=1e-12), {}),
}


@pytest.fixture(scope="module", params=list(ROUTED))
def routed(request, qwen):
    """One case of ``ROUTED`` served by JAX's router and the port's."""
    jcfg, cfg, params = qwen
    seed, rkw, kw = ROUTED[request.param]
    reqs = _requests(seed, 8 if seed < 2 else 5, cfg.vocab_size)
    if request.param == "shed":
        geom = dict(num_slots=2, block_size=8, num_blocks=20, max_blocks_per_slot=8)
    else:
        geom = GEOM
    jouts, jrouter = _route(lambda clock: JRouter(
        jcfg, jax.tree.map(jnp.asarray, params), JaxServeConfig(**geom),
        JRouterConfig(**rkw), clock=clock, **kw), reqs)
    outs, router = _route(lambda clock: Router(
        cfg, from_jax_params(params, device="cpu"), ServeConfig(**geom),
        RouterConfig(**rkw), clock=clock, device="cpu", **kw), reqs)
    return request.param, seed, reqs, (outs, router), (jouts, jrouter)


def test_router_streams_equal_jax(routed, single):
    case, seed, reqs, (outs, router), (jouts, _) = routed
    assert outs == jouts
    if case == "shed":
        assert outs == {}
        assert set(router.shed_rids) == set(range(len(reqs)))
    else:
        assert outs == single[seed]
        assert all(len(outs[i]) == mn for i, (_, mn, _) in enumerate(reqs))


def test_router_metrics_equal_jax(routed):
    """Under the shared tick clock the fleet metrics, placement spread,
    migrations and shed rate are JAX's key for key."""
    case, _, reqs, (_, router), (_, jrouter) = routed
    met = router.metrics()
    _equal(met, jrouter.metrics())
    assert router.placed == jrouter.placed
    assert router.shed_rids == pytest.approx(jrouter.shed_rids, abs=FLOAT_TOL)
    if case == "shed":
        assert met["shed"] == len(reqs) and met["shed_rate"] == 1.0
    else:
        assert met["finished"] == len(reqs) and met["shed"] == 0
        assert sum(met["placed_per_replica"]) == len(reqs)
    if case in ("round_robin", "least_kv", "jsq", "thinned"):
        assert all(n > 0 for n in met["placed_per_replica"])


def test_router_trace_equals_jax(routed):
    """The same events on the same lanes (replicas rank 0 and 1, the
    router rank 2): routes, sheds, prefills, decode ticks and, when
    disaggregated, every export, import and migration."""
    case, _, _, (_, router), (_, jrouter) = routed
    ev = router.trace_events()
    names = collections.Counter((e.name, e.rank) for e in ev)
    assert names == collections.Counter((e.name, e.rank) for e in jrouter.trace_events())
    assert [e.ts for e in ev] == sorted(e.ts for e in ev)
    if case == "disaggregated":
        met = router.metrics()
        assert met["migrations"] > 0
        assert {"kv_export", "kv_import", "migrate", "route"} <= {e.name for e in ev}
        assert {e.rank for e in ev if e.name == "kv_export"} == {0}
        assert {e.rank for e in ev if e.name in ("kv_import", "decode")} == {1}
        assert {e.kind for e in ev if e.name.startswith("kv_")} == {"comm"}
        # decode happened only on the decode tier
        assert all(len(r.generated) <= 1
                   for r in router.replicas[0].sched.requests.values())
        assert router.replicas[0].prefill_only and not router.replicas[1].prefill_only


def test_router_replicas_share_one_cast_of_the_weights(qwen):
    _, cfg, params = qwen
    router = Router(cfg, from_jax_params(params, device="cpu"),
                    ServeConfig(**GEOM), RouterConfig(replicas=2), device="cpu")
    a, b = (r.params for r in router.replicas)
    leaves = [(x, y) for (_, x), (_, y) in zip(_flat(a), _flat(b))]
    assert leaves and all(x is y for x, y in leaves)
    assert [r.tracer.rank for r in router.replicas] == [0, 1]
    assert router.tracer.rank == 2
    assert [r._m("tokens") for r in router.replicas] == ["serve.r0.tokens",
                                                          "serve.r1.tokens"]


def test_router_refuses_bad_replica_lists_and_precompile(qwen, single, tmp_path):
    """Bad replica lists are refused; ``compile_cache=`` reaches every
    replica and ``precompile()`` (no longer refused) sums their ladders,
    as JAX's ``Router.precompile`` does: each replica's, a single
    ``MegaServe``'s, held to JAX's in tests/test_torch_precompile.py.  The
    precompiled fleet, and a precompiled single engine, then serve JAX's
    streams."""
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.kernels import _build

    _, cfg, params = qwen
    p = from_jax_params(params, device="cpu")
    scfg = ServeConfig(**GEOM)
    for kw in (dict(replica_step_every=[1]), dict(replica_step_every=[1, 0]),
               dict(replica_wrap_steps=[None])):
        with pytest.raises(ValueError):
            Router(cfg, p, scfg, RouterConfig(replicas=2), device="cpu", **kw)
    cache = CompileCache(tmp_path)
    cached = Router(cfg, p, scfg, RouterConfig(replicas=2), device="cpu",
                    compile_cache=cache)
    assert all(r.compile_cache is cache for r in cached.replicas)
    try:
        rep = cached.precompile()
    finally:
        _build.use_cache(None)
    one = MegaServe(cfg, p, scfg, device="cpu").precompile()
    assert {k: v["count"] for k, v in rep.items() if k != "total"} == {
        k: 2 * v["count"] for k, v in one.items() if k != "total"}
    assert rep["total"] == 2 * one["total"] == 16
    # the second replica's buckets hit the first's records
    assert cache.stats.as_dict() == {"hits": 8, "misses": 8, "puts": 8, "errors": 0}
    engine = MegaServe(cfg, p, scfg, device="cpu")
    engine.precompile()
    for srv in (cached, engine):
        for prompt, mn, a in _requests(0, 8, cfg.vocab_size):
            srv.submit(prompt, mn, arrival=a)
        assert srv.drain() == single[0]
    router = Router(cfg, p, scfg, RouterConfig(replicas=2), device="cpu")
    # reset() refuses in-flight work, then restarts a drained fleet
    router.submit([5, 6, 7], 3, arrival=0.0)
    with pytest.raises(RuntimeError):
        router.reset()
    first = router.drain()
    router.reset()
    assert router.metrics()["submitted"] == 0 and router.trace_events() == []
    router.submit([5, 6, 7], 3, arrival=0.0)
    assert router.drain() == first
