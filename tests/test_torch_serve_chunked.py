"""MegaServe's prefill paths in the port against the JAX package's.

At float32 on the CPU (the plain K4 version, and the dense attention of the
dense prefill), on the same weights and prompts: flash, dense and chunked
prefill and speculative verification, K4's served shapes (a whole prompt,
chunks over a cached prefix, Q = spec_k + 1 over ragged slots), give JAX's
greedy streams and metrics counters, also through preemption-by-recompute;
the prefill paths resolve and refuse as JAX's do; and the registry
publishes JAX's serve series names.  The cases mirror
``tests/test_flash_prefill.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.obs import MetricsRegistry as JaxRegistry  # noqa: E402
from repro.serve import MegaServe as JaxMegaServe  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve.server import StaticRunner as JaxStaticRunner  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.weights import from_jax_params  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    MegaServe,
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


# --------------------------------------------- flash / dense / chunked ---


def _flash_geom(**kw):
    return dict(dict(num_slots=4, block_size=16, num_blocks=40,
                     max_blocks_per_slot=8, decode_path="paged"), **kw)


def test_flash_prefill_token_identity(qwen):
    """Flash and dense prefill give JAX's dense-prefill streams on ragged
    prompts (non-block-multiples included)."""
    prompts = _prompts(0, (5, 17, 33, 64), qwen[1].vocab_size, lo=1)
    ref, _ = _serve(qwen, prompts, 8, side="jax", **_flash_geom(prefill_path="dense"))
    dense, dsrv = _serve(qwen, prompts, 8, **_flash_geom(prefill_path="dense"))
    flash, fsrv = _serve(qwen, prompts, 8, **_flash_geom(prefill_path="flash"))
    assert flash == dense == ref
    assert (dsrv.prefill_path, fsrv.prefill_path) == ("dense", "flash")
    _, auto = _serve(qwen, prompts[:1], 8, **_flash_geom(prefill_path="auto"))
    assert auto.prefill_path == "flash"


def test_flash_prefill_chunked_and_spec_identity(qwen):
    """K4's three served shapes, full prefill, chunks over a cached prefix
    and the Q = spec_k + 1 verify step, give the dense streams, and JAX's
    chunked and speculative streams and counters."""
    prompts = _prompts(0, (5, 17, 33, 64), qwen[1].vocab_size, lo=1)
    dense, _ = _serve(qwen, prompts, 8, **_flash_geom(prefill_path="dense"))
    for extra in (dict(chunked_prefill=True), dict(spec_decode=True),
                  dict(chunked_prefill=True, spec_decode=True, chunk_len=48)):
        got, srv = _serve(qwen, prompts, 8, **_flash_geom(prefill_path="flash", **extra))
        want, jsrv = _serve(qwen, prompts, 8, side="jax",
                            **_flash_geom(prefill_path="flash", **extra))
        assert got == dense == want, extra
        assert _counters(srv) == _counters(jsrv), extra
        if "spec_decode" in extra:
            assert srv.metrics()["spec_accepted"] > 0
        if "chunked_prefill" in extra:
            names = [e.name for e in srv.trace_events()]
            assert names.count("prefill_chunk") == sum(
                -(-len(p) // srv.serve_cfg.resolved_chunk_len) for p in prompts
                if len(p) > srv.serve_cfg.resolved_chunk_len)


def test_flash_prefill_preemption_identity(qwen):
    """Preempt/recompute round trips through the flash path and through
    chunked prefill (16-token chunks) land on the static streams."""
    prompts = _prompts(1, (16, 16, 16), qwen[1].vocab_size)
    ref, _ = _static(qwen, prompts, [12] * 3, 3, side="jax")
    geom = _flash_geom(num_slots=3, block_size=8, num_blocks=9,
                       max_blocks_per_slot=4, prefill_path="flash")
    for extra in ({}, dict(chunked_prefill=True, chunk_len=8)):
        outs, srv = _serve(qwen, prompts, 12, **geom, **extra)
        _, jsrv = _serve(qwen, prompts, 12, side="jax", **geom, **extra)
        assert srv.metrics()["preemptions"] > 0, extra
        assert outs == ref, extra
        assert _counters(srv) == _counters(jsrv), extra


def test_flash_requires_paged_pool(qwen):
    """prefill_path=flash and chunked prefill on the gathered path, chunked
    prefill on a recurrent family, and a chunk_len off the block grid fail
    loudly, as in JAX."""
    _, cfg, params = qwen
    tp = from_jax_params(params, device="cpu")
    geom = dict(num_slots=2, block_size=16, num_blocks=20, max_blocks_per_slot=4,
                decode_path="gathered")
    with pytest.raises(ValueError, match="flash"):
        MegaServe(cfg, tp, ServeConfig(**geom, prefill_path="flash"), device="cpu")
    with pytest.raises(ValueError, match="chunked_prefill"):
        MegaServe(cfg, tp, ServeConfig(**geom, chunked_prefill=True), device="cpu")
    rcfg = get_config("rwkv6-3b", smoke=True)
    with pytest.raises(ValueError, match="chunked_prefill"):
        MegaServe(rcfg, lm.init(rcfg, seed=0, device="cpu"),
                  ServeConfig(chunked_prefill=True), device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        ServeConfig(block_size=16, chunk_len=24)
    assert ServeConfig(block_size=16).resolved_chunk_len == 32


def test_serve_series_names_equal_jax(qwen):
    """Chunked and speculative serving publish JAX's serve series under the
    same names, with the same token and speculation counts."""
    prompts = _prompts(0, (5, 17, 33, 64), qwen[1].vocab_size, lo=1)
    geom = _flash_geom(prefill_path="flash", chunked_prefill=True, spec_decode=True)
    reg, jreg = MetricsRegistry(), JaxRegistry()
    _serve(qwen, prompts, 8, registry=reg, **geom)
    _serve(qwen, prompts, 8, side="jax", registry=jreg, **geom)
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    assert set(snap) == set(jsnap)
    for name in ("serve.tokens", "serve.spec_proposed", "serve.spec_accepted"):
        assert snap[name] == jsnap[name], name
    assert snap["serve.chunk_s"]["count"] == jsnap["serve.chunk_s"]["count"] > 0
