"""MegaServe's single-engine paths in the port against the JAX package's.

At float32 on the CPU (the plain K3/K4 versions and the dense attention of
the gathered and static paths), on the same weights and prompts:

* the gathered decode path (``PagedKVCache.gather``, one B=1 forward a
  slot, ``scatter_decode``) and static lockstep serving give JAX's greedy
  streams and metrics counters, also through preemption-by-recompute and
  for the recurrent families;
* ``decode_path`` resolves as JAX's does;
* MegaScope captures attached to each stream token equal JAX's within
  1e-5, on the gathered path (per slot) and the paged one (whole);
* the pool's gather/scatter round trips leave it as JAX's leaves its own.

The cases mirror ``tests/test_serving.py``; the prefill paths' are in
``tests/test_torch_serve_chunked.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.scope import ProbeSpec as JaxProbeSpec  # noqa: E402
from repro.core.scope import ScopeCollector as JaxScopeCollector  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import MegaServe as JaxMegaServe  # noqa: E402
from repro.serve import PagedKVCache as JaxPagedKVCache  # noqa: E402
from repro.serve import PoolSpec as JaxPoolSpec  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve.server import StaticRunner as JaxStaticRunner  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.scope import ProbeSpec, ScopeCollector  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.weights import from_jax_params  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    MegaServe,
    PagedKVCache,
    PoolSpec,
    ServeConfig,
    StaticRunner,
)


def _model(arch, **rep):
    jcfg = jax_get_config(arch, smoke=True).replace(compute_dtype="float32", **rep)
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32", **rep)
    params = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, params


@pytest.fixture(scope="module")
def qwen():
    return _model("qwen2-0.5b", attn_kv_chunk=4096)


def _serve(model, prompts, max_new, *, side="torch", collector=None,
           registry=None, **geom):
    """Drain ``prompts`` (all arriving at 0) through one server; returns
    ``(streams, server)``.  JAX runs its XLA reference attention."""
    jcfg, cfg, params = model
    kw = {} if collector is None else {"collector": collector}
    if registry is not None:
        kw["registry"] = registry
    if side == "jax":
        srv = JaxMegaServe(jcfg, jax.tree.map(jnp.asarray, params),
                           JaxServeConfig(**geom, paged_attn_impl="xla"), **kw)
    else:
        srv = MegaServe(cfg, from_jax_params(params, device="cpu"),
                        ServeConfig(**geom), device="cpu", **kw)
    for p in prompts:
        srv.submit(p, max_new, arrival=0.0)
    return srv.drain(), srv


def _static(model, prompts, max_new, batch_size, *, side="torch"):
    jcfg, cfg, params = model
    reqs = [(p, m, 0.0) for p, m in zip(prompts, max_new)]
    if side == "jax":
        return JaxStaticRunner(jcfg, jax.tree.map(jnp.asarray, params)).run(
            reqs, batch_size=batch_size)
    return StaticRunner(cfg, from_jax_params(params, device="cpu"),
                        device="cpu").run(reqs, batch_size=batch_size)


_COUNTERS = ("generated_tokens", "finished", "preemptions", "steps",
             "spec_proposed", "spec_accepted")


def _counters(srv):
    met = srv.metrics()
    return {k: met[k] for k in _COUNTERS if k in met}


def _prompts(seed, lens, vocab, lo=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, vocab, size=n).tolist() for n in lens]


# ---------------------------------------------------- gather / scatter ---


def _pools(cfg, jcfg):
    spec = dict(num_slots=2, num_blocks=9, block_size=8, max_blocks=4)
    return (PagedKVCache(cfg, PoolSpec(**spec), torch.device("cpu")),
            JaxPagedKVCache(jcfg, JaxPoolSpec(**spec)))


def _flat(tree):
    return [x for v in tree.values()
            for x in (_flat(v) if isinstance(v, dict) else [v])]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def test_paged_prefill_gather_roundtrip(qwen):
    """A random one-row dense cache scattered into blocks 3 and 5 of slot 1
    and gathered back: the slot's first 16 positions are the cache, and the
    pool and the gathered view equal JAX's."""
    jcfg, cfg, _ = qwen
    kv, jkv = _pools(cfg, jcfg)
    rng = np.random.default_rng(1)
    filled = lm.init_cache(cfg, 1, 16, device="cpu")
    filled = lm.tree_map(lambda a: torch.from_numpy(
        rng.standard_normal(a.shape).astype(np.float32)).to(a.dtype), filled)
    jfilled = jax.tree.map(lambda a: jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32), filled)
    kv.scatter_prefill(kv.pool, filled, 1, torch.tensor([3, 5], dtype=torch.int32))
    jpool = jkv.scatter_prefill(jkv.pool, jfilled, jnp.int32(1),
                                jnp.asarray([3, 5], jnp.int32))
    tables = np.zeros((2, 4), np.int32)
    tables[1, :2] = [3, 5]
    dense = kv.gather(kv.pool, torch.from_numpy(tables))
    jdense = jkv.gather(jpool, jnp.asarray(tables))
    for d, f, paged in zip(_flat(dense), _flat(filled), _flat(kv.paged)):
        want = f[:, 0]
        got = d[:, 1, :16] if paged else d[:, 1]
        assert torch.equal(got, want)
    for a, b in zip(_flat(dense), jax.tree.leaves(jdense)):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(_flat(kv.pool), jax.tree.leaves(jpool)):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_scatter_decode_touches_only_written_block(qwen):
    """Slot 0 writes at position 9 (its block 1 = pool block 4), slot 1 at 3
    (block 0 = pool block 6): only those blocks change, as in JAX."""
    jcfg, cfg, _ = qwen
    kv, jkv = _pools(cfg, jcfg)
    tables = np.zeros((2, 4), np.int32)
    tables[0, :2] = [2, 4]
    tables[1, :2] = [6, 7]
    pos = np.asarray([9, 3], np.int32)
    dense = kv.gather(kv.pool, torch.from_numpy(tables))
    dense = lm.tree_map(lambda a, paged: a + 1.0 if paged else a, dense, kv.paged)
    kv.scatter_decode(kv.pool, dense, torch.from_numpy(tables), torch.from_numpy(pos))
    jdense = jkv.gather(jkv.pool, jnp.asarray(tables))
    jdense = jax.tree.map(lambda a: a + 1.0 if a.ndim > 2 else a, jdense)
    jpool = jkv.scatter_decode(jkv.pool, jdense, jnp.asarray(tables), jnp.asarray(pos))
    for leaf, paged, jleaf in zip(_flat(kv.pool), _flat(kv.paged),
                                  jax.tree.leaves(jpool)):
        np.testing.assert_array_equal(_np(leaf), _np(jleaf))
        if not paged:
            continue
        arr = _np(leaf)
        assert np.all(arr[:, 4] != 0) and np.all(arr[:, 6] != 0)
        assert np.all(arr[:, 2] == 0) and np.all(arr[:, 7] == 0)


# ------------------------------------------------- continuous vs static ---


@pytest.mark.parametrize("path", ["paged", "gathered"])
def test_continuous_greedy_matches_static(qwen, path):
    """Mixed budgets on 2 slots: MegaServe's streams equal the port's and
    JAX's StaticRunner outputs, with JAX's counters on the same path, in
    fewer engine steps than lockstep."""
    prompts = _prompts(0, (16, 16, 32, 16), qwen[1].vocab_size)
    max_new = [6, 3, 5, 4]
    geom = dict(num_slots=2, block_size=8, num_blocks=33, max_blocks_per_slot=6,
                decode_path=path)
    srv = MegaServe(qwen[1], from_jax_params(qwen[2], device="cpu"),
                    ServeConfig(**geom), device="cpu")
    jsrv = JaxMegaServe(qwen[0], jax.tree.map(jnp.asarray, qwen[2]),
                        JaxServeConfig(**geom, paged_attn_impl="xla"))
    assert srv.decode_path == jsrv.decode_path == path
    for s in (srv, jsrv):
        for p, m in zip(prompts, max_new):
            s.submit(p, m, arrival=0.0)
    outs, jouts = srv.drain(), jsrv.drain()
    ref, ref_met = _static(qwen, prompts, max_new, 2)
    jref, _ = _static(qwen, prompts, max_new, 2, side="jax")
    assert outs == jouts == ref == jref
    assert _counters(srv) == _counters(jsrv)
    met = srv.metrics()
    assert met["generated_tokens"] == sum(max_new) == ref_met["generated_tokens"]
    assert met["finished"] == 4 and met["preemptions"] == 0
    assert met["steps"] < 6 + 5 + 2


@pytest.mark.parametrize("path", ["paged", "gathered"])
def test_preemption_recompute_preserves_outputs(qwen, path):
    """8 usable blocks of 8 for three 16+12-token sequences: both decode
    paths preempt as JAX's do and recompute to the static streams."""
    prompts = _prompts(1, (16, 16, 16), qwen[1].vocab_size)
    ref, _ = _static(qwen, prompts, [12] * 3, 3, side="jax")
    geom = dict(num_slots=3, block_size=8, num_blocks=9, max_blocks_per_slot=4,
                decode_path=path)
    outs, srv = _serve(qwen, prompts, 12, **geom)
    _, jsrv = _serve(qwen, prompts, 12, side="jax", **geom)
    assert srv.metrics()["preemptions"] > 0
    assert outs == ref
    assert _counters(srv) == _counters(jsrv)


def test_decode_path_auto_selection(qwen):
    _, cfg, params = qwen
    tp = from_jax_params(params, device="cpu")
    scfg = dict(num_slots=2, block_size=8, num_blocks=17, max_blocks_per_slot=4)
    srv = MegaServe(cfg, tp, ServeConfig(**scfg), device="cpu")
    assert (srv.decode_path, srv.prefill_path) == ("paged", "flash")
    # a live MegaScope collector takes the gathered oracle (per-slot
    # captures), whose prefill is the dense one
    scope = ScopeCollector(probes=[ProbeSpec("final_hidden", "stats")])
    srv = MegaServe(cfg, tp, ServeConfig(**scfg), device="cpu", collector=scope)
    assert (srv.decode_path, srv.prefill_path) == ("gathered", "dense")
    # ...unless speculation asks for the paged path
    srv = MegaServe(cfg, tp, ServeConfig(**scfg, spec_decode=True), device="cpu",
                    collector=scope)
    assert srv.decode_path == "paged"
    with pytest.raises(ValueError, match="decode_path"):
        MegaServe(cfg, tp, ServeConfig(**scfg, decode_path="bogus"), device="cpu")
    with pytest.raises(ValueError, match="prefill_path"):
        MegaServe(cfg, tp, ServeConfig(**scfg, prefill_path="bogus"), device="cpu")


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_gathered_path_state_families_match_static(arch):
    """The recurrent families on the gathered path (segment prefill, then
    one B=1 dense forward a slot whose state rows are the pool's own) give
    the static streams of the port and of JAX."""
    model = _model(arch)
    prompts = _prompts(5, (8, 16), model[1].vocab_size)
    outs, srv = _serve(model, prompts, 4, num_slots=2, block_size=8,
                       num_blocks=17, max_blocks_per_slot=4,
                       decode_path="gathered")
    assert srv.decode_path == "gathered" and srv.prefill_path == "dense"
    ref, _ = _static(model, prompts, [4, 4], 1)
    jref, _ = _static(model, prompts, [4, 4], 1, side="jax")
    assert outs == ref == jref


# ------------------------------------------------------------- captures ---


def _leaf_map(tree, pre=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_map(v, pre + (k,)))
        else:
            out[pre + (k,)] = np.asarray(v, np.float64)
    return out


@pytest.mark.parametrize("arch,path,probes", [
    ("qwen2-0.5b", "auto", ("final_hidden:stats", "mlp_hidden:stats", "q:channels")),
    ("qwen2-0.5b", "paged", ("final_hidden:stats", "k:stats", "attn_out:channels")),
    ("rwkv6-3b", "auto", ("final_hidden:stats", "att_resid:stats")),
    ("recurrentgemma-9b", "auto", ("final_hidden:stats", "att_resid:stats")),
])
def test_trace_events_and_scope_captures(arch, path, probes):
    """Every stream token carries its captures: the prefill's, then the
    gathered decode's slot slice (or the batched paged step's whole
    captures), each leaf equal to JAX's within 1e-5 (relative to the leaf's
    scale); the trace holds prefill and decode scopes."""
    from repro_torch.core.tracing.chrome import to_chrome

    model = _model(arch, **({"attn_kv_chunk": 4096} if arch == "qwen2-0.5b" else {}))
    specs = [p.split(":") for p in probes]
    geom = dict(num_slots=2, block_size=8, num_blocks=17, max_blocks_per_slot=4,
                decode_path=path)
    prompts = _prompts(3, (8, 13), model[1].vocab_size)
    outs, srv = _serve(model, prompts, 3, collector=ScopeCollector(
        probes=[ProbeSpec(*s) for s in specs]), **geom)
    jouts, jsrv = _serve(model, prompts, 3, side="jax", collector=JaxScopeCollector(
        probes=[JaxProbeSpec(*s) for s in specs]), **geom)
    assert outs == jouts
    assert srv.decode_path == jsrv.decode_path
    kinds = {e.name for e in srv.trace_events()}
    assert {"prefill", "decode"} <= kinds
    assert to_chrome(srv.trace_events())["traceEvents"]
    for rid in outs:
        assert len(srv.streams[rid]) == 3
        for it, jit_ in zip(srv.streams[rid], jsrv.streams[rid]):
            got, want = _leaf_map(it.captures), _leaf_map(jit_.captures)
            assert any("final_hidden" in "/".join(k) for k in got)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].shape == want[k].shape, k
                scale = max(1.0, float(np.abs(want[k]).max()))
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=1e-5 * scale, err_msg=str(k))
