"""``MegaServe.precompile()`` against ``repro.serve.MegaServe.precompile()``
on the CPU: the same ladders walked for the same ``ServeConfig`` (decode and
verify over the table-width ladder, the reachable chunk widths, the prompt
block buckets, a recurrent family's segment-width x cache-bucket grid with a
finish per bucket), the same report, and a warm-up that leaves the server
as it found it: greedy streams equal with and without it, the null block,
the slot states, the scheduler and the kernels' launch counters untouched.
Through one ``CompileCache`` a second server hits every record the first
put.  JAX's ladder is walked with its AOT compile stubbed out (the XLA
compile is not what is compared, and takes seconds a bucket on the CPU);
the streams of a precompiled engine are held to JAX's in
tests/test_torch_router.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import MegaServe as JaxMegaServe  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.compile_cache import CompileCache  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serve import MegaServe, ServeConfig  # noqa: E402
from repro_torch.serve.server import _launch_counters  # noqa: E402

PATHS = ("decode", "prefill", "chunk", "verify")
GEOM = dict(num_slots=3, block_size=8, num_blocks=40, max_blocks_per_slot=8)
CASES = {
    "paged": ("qwen2-0.5b", GEOM, dict(decode=4, prefill=4, chunk=0, verify=0)),
    "chunked-spec": ("qwen2-0.5b", dict(GEOM, chunked_prefill=True, chunk_len=16,
                                        spec_decode=True),
                     dict(decode=4, prefill=4, chunk=3, verify=4)),
    "gathered": ("qwen2-0.5b", dict(GEOM, decode_path="gathered"),
                 dict(decode=1, prefill=4, chunk=0, verify=0)),
    "rwkv6-segments": ("rwkv6-3b", dict(num_slots=2, block_size=8, num_blocks=24,
                                        max_blocks_per_slot=4),
                       dict(decode=3, prefill=18, chunk=0, verify=0)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, where
    the small ops here spin-wait on torch's thread pool against each other
    (30x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_counts(arch: str, geom: dict) -> dict:
    """JAX's report counts, its ladders walked without XLA."""
    cfg = jax_get_config(arch, smoke=True)
    srv = JaxMegaServe(cfg, jlm.init(cfg, jax.random.PRNGKey(0)), JaxServeConfig(**geom))
    srv._aot = lambda jitted, avatars, **kw: (jitted, False)
    rep = srv.precompile()
    return {p: rep[p]["count"] for p in PATHS} | {"total": rep["total"]}


def _prompts(cfg, seed=0, lens=(5, 17, 33)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in lens]


@pytest.fixture(scope="module")
def models():
    return {arch: (get_config(arch, smoke=True),
                   lm.init(get_config(arch, smoke=True), seed=0, device="cpu"))
            for arch in ("qwen2-0.5b", "rwkv6-3b")}


@pytest.mark.parametrize("case", list(CASES))
def test_precompile_walks_jaxs_ladders(case, models):
    arch, geom, want = CASES[case]
    cfg, params = models[arch]
    reg = MetricsRegistry()
    rep = MegaServe(cfg, params, ServeConfig(**geom), device="cpu",
                    registry=reg).precompile()
    counts = {p: rep[p]["count"] for p in PATHS} | {"total": rep["total"]}
    assert counts == _jax_counts(arch, geom) == want | {"total": sum(want.values())}
    assert set(rep) == set(PATHS) | {"total"}
    snap = reg.snapshot()
    for p in PATHS:
        assert snap[f"serve.precompile_ms.{p}"] == rep[p]["ms"]
        assert (rep[p]["ms"] > 0) == (rep[p]["count"] > 0)


@pytest.mark.parametrize("case", ["chunked-spec", "rwkv6-segments"])
def test_precompile_leaves_the_server_as_it_found_it(case, models):
    """Streams with and without the warm-up are equal; what a warm-up step
    can write (the null block, every slot's state), the scheduler, the RNG
    and every kernel's launch count are as before it, also mid-run."""
    arch, geom, _ = CASES[case]
    cfg, params = models[arch]
    prompts = _prompts(cfg, lens=(5, 17, 20))

    def serve(warm: bool):
        srv = MegaServe(cfg, params, ServeConfig(**geom), device="cpu")
        for p in prompts[:2]:
            srv.submit(p, 6)
        srv.step()
        if warm:
            pool = lm.tree_map(torch.clone, srv.pool)
            sched = (list(srv.sched.pos), srv.sched.tables.tolist(),
                     list(srv.sched.slots), srv.step_idx)
            for c in _launch_counters():  # as the card's counters would be
                for k in c:
                    c[k] += 3
            counts = [dict(c) for c in _launch_counters()]
            rng = torch.random.get_rng_state()
            srv.precompile()
            assert all(torch.equal(a, b) for a, b in zip(
                lm.tree_leaves(pool), lm.tree_leaves(srv.pool)))
            assert (list(srv.sched.pos), srv.sched.tables.tolist(),
                    srv.sched.slots, srv.step_idx) == sched
            assert [dict(c) for c in _launch_counters()] == counts
            assert torch.equal(torch.random.get_rng_state(), rng)
        for p in prompts[2:]:
            srv.submit(p, 6)
        return srv.drain()

    assert serve(True) == serve(False)


def test_cold_then_warm_through_one_cache(tmp_path, models):
    """A second server hits every record the first put (0 misses), and the
    two serve the same streams as one without a cache."""
    cfg, params = models["qwen2-0.5b"]
    scfg = ServeConfig(**dict(GEOM, chunked_prefill=True, chunk_len=16))
    prompts = _prompts(cfg, 1)

    def serve(cache):
        srv = MegaServe(cfg, params, scfg, device="cpu", compile_cache=cache)
        rep = srv.precompile()
        for p in prompts:
            srv.submit(p, 6)
        return srv.drain(), rep

    try:
        out_cold, cold = serve(CompileCache(tmp_path))
        out_warm, warm = serve(CompileCache(tmp_path))
    finally:
        _build.use_cache(None)
    assert cold["cache"] == {"hits": 0, "misses": 11, "puts": 11, "errors": 0}
    assert warm["cache"] == {"hits": cold["cache"]["puts"], "misses": 0,
                             "puts": 0, "errors": 0}
    assert cold["total"] == warm["total"] == 11
    out_ref, ref = serve(None)
    assert "cache" not in ref
    assert out_cold == out_warm == out_ref
