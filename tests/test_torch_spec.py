"""Speculative decoding in the port against the JAX package's.

The drafters (``repro_torch.serve.spec``) are host numpy copies: the same
history gives the same drafts as ``repro.serve.spec``'s, the random drafter's
token for token.  The scheduler's speculative capacity and rewind keep JAX's
block accounting.  Served end to end at float32 (the plain K4 version on the
CPU), speculative greedy streams equal plain decoding's and JAX's
speculative ones, with the same proposal and acceptance counts, through
preemption, eos inside an accepted run, an adversarial drafter that
adaptation shuts off, and attention-only Griffin.  The cases mirror
``tests/test_serving.py``'s speculative ones.
"""

from dataclasses import replace as dc_replace

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import MegaServe as JaxMegaServe  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import Scheduler as JaxScheduler  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import spec as jspec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.weights import from_jax_params  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    MegaServe,
    NGramDrafter,
    RandomDrafter,
    Request,
    Scheduler,
    ServeConfig,
    get_drafter,
)


def _pair(arch, **rep):
    jcfg = jax_get_config(arch, smoke=True).replace(compute_dtype="float32", **rep)
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32", **rep)
    return jcfg, cfg


@pytest.fixture(scope="module")
def qwen():
    jcfg, cfg = _pair("qwen2-0.5b", attn_kv_chunk=4096)
    params = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, params


def _serve(model, prompts, max_new, *, side="torch", drafter=None, eos_id=None,
           **geom):
    """Drain ``prompts`` (all arriving at 0) through one server; returns
    ``(streams, server)``.  JAX serves through its paged path with the XLA
    reference attention, dense prefill (what its CPU "auto" picks)."""
    jcfg, cfg, params = model
    if side == "jax":
        jd = None if drafter is None else type(drafter).__name__
        jd = jd and getattr(jspec, jd)(cfg.vocab_size, seed=drafter.seed)
        srv = JaxMegaServe(jcfg, jax.tree.map(jax.numpy.asarray, params),
                           JaxServeConfig(**geom, paged_attn_impl="xla"),
                           drafter=jd)
    else:
        srv = MegaServe(cfg, from_jax_params(params, device="cpu"),
                        ServeConfig(**geom), device="cpu", drafter=drafter)
    for p in prompts:
        srv.submit(p, max_new, arrival=0.0, eos_id=eos_id)
    return srv.drain(), srv


_COUNTERS = ("generated_tokens", "finished", "preemptions", "steps",
             "spec_proposed", "spec_accepted")


def _counters(srv):
    met = srv.metrics()
    return {k: met[k] for k in _COUNTERS if k in met}


# ------------------------------------------------------------- drafters ---


def test_ngram_drafter_prompt_lookup():
    d = NGramDrafter(max_ngram=3, min_ngram=1)
    assert d.propose([7, 8, 9, 1, 7, 8], 2) == [9, 1]
    assert d.propose([7, 8, 9, 1, 7, 8], 4) == [9, 1, 7, 8]
    assert d.propose([1, 2, 3, 4, 5], 3) == []
    assert d.propose([5], 3) == []
    assert d.propose([7, 8, 9], 0) == []
    # the most recent match wins over an older one
    assert d.propose([2, 5, 1, 2, 6, 1, 2], 1) == [6]
    # and a full-length continuation wins over a more recent truncated one
    assert d.propose([1, 2, 3, 4, 1, 2, 1, 2], 3) == [3, 4, 1]


def test_drafters_equal_jax_on_random_histories():
    """Periodic and random histories, every k: the n-gram drafter's and the
    random drafter's proposals equal JAX's token for token."""
    rng = np.random.default_rng(0)
    ours = [NGramDrafter(), NGramDrafter(max_ngram=2, min_ngram=2),
            RandomDrafter(1000, seed=3), get_drafter("random", vocab_size=50)]
    theirs = [jspec.NGramDrafter(), jspec.NGramDrafter(max_ngram=2, min_ngram=2),
              jspec.RandomDrafter(1000, seed=3),
              jspec.get_drafter("random", vocab_size=50)]
    for trial in range(40):
        n = int(rng.integers(1, 60))
        if trial % 2:
            hist = rng.integers(2, 9, size=n).tolist()
        else:
            period = rng.integers(2, 9, size=int(rng.integers(1, 6))).tolist()
            hist = (period * 20)[:n]
        for k in (0, 1, 3, 5):
            for a, b in zip(ours, theirs):
                assert a.propose(hist, k) == b.propose(hist, k), (hist, k)


def test_get_drafter_kinds():
    assert isinstance(get_drafter("ngram"), NGramDrafter)
    assert isinstance(get_drafter("random", vocab_size=10), RandomDrafter)
    with pytest.raises(ValueError):
        get_drafter("model")
    with pytest.raises(ValueError):
        NGramDrafter(max_ngram=1, min_ngram=2)


# ------------------------------------------------------------ scheduler ---


def test_scheduler_spec_capacity_and_trim():
    """A 4-draft verify grows the table to 3 blocks; a commit of 2 trims it
    back to 2 and re-points the freed entries at the null block, as JAX's
    scheduler does, step for step."""
    geom = dict(num_slots=1, block_size=4, num_blocks=8, max_blocks_per_slot=6,
                max_prefills_per_step=1)
    ours, theirs = Scheduler(ServeConfig(**geom)), JaxScheduler(JaxServeConfig(**geom))
    for s, R in ((ours, Request), (theirs, JaxRequest)):
        s.submit(R(rid=0, prompt=list(range(4)), max_new=12))
        s.admit(now=0.0)
    assert len(ours.blocks[0]) == 1 and ours.pos[0] == 4
    assert ours.ensure_capacity({0: 5}) == theirs.ensure_capacity({0: 5}) == []
    assert len(ours.blocks[0]) == 3
    for s in (ours, theirs):
        s.advance(0, 2)
        s.trim_blocks()
    assert len(ours.blocks[0]) == 2
    assert ours.allocator.num_held == 2
    assert list(ours.tables[0, 2:]) == [0] * 4
    np.testing.assert_array_equal(ours.tables, theirs.tables)
    assert ours.blocks == theirs.blocks


# ------------------------------------------------------- served streams ---


def test_spec_greedy_matches_nonspec_paged_and_jax(qwen):
    """Speculative greedy streams equal plain paged decoding's and JAX's
    speculative ones, with JAX's proposal, acceptance and step counts, and
    fewer engine steps than plain decoding."""
    rng = np.random.default_rng(21)
    prompts = [rng.integers(2, qwen[1].vocab_size, size=n).tolist()
               for n in (16, 16, 32, 16)]
    base = dict(num_slots=2, block_size=8, num_blocks=33, max_blocks_per_slot=8)
    geom = dict(base, spec_decode=True, spec_k=4)
    ref, plain = _serve(qwen, prompts, 12, **base)
    got, srv = _serve(qwen, prompts, 12, **geom)
    want, jsrv = _serve(qwen, prompts, 12, side="jax", **geom)
    assert got == ref == want
    assert _counters(srv) == _counters(jsrv)
    met = srv.metrics()
    assert met["spec_proposed"] > 0 and met["spec_accepted"] > 0
    assert met["steps"] < plain.metrics()["steps"]
    assert srv.decode_path == "paged" and srv.prefill_path == "flash"
    names = {e.name for e in srv.trace_events()}
    assert {"draft", "verify", "accept"} <= names


def test_spec_preemption_roundtrip_preserves_outputs(qwen):
    """8 usable blocks of 8 for three 16+12-token sequences under
    speculation: preemptions as JAX's, streams equal JAX's and plain
    decoding's."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, qwen[1].vocab_size, size=16).tolist()
               for _ in range(3)]
    geom = dict(num_slots=3, block_size=8, num_blocks=9, max_blocks_per_slot=4)
    ref, _ = _serve(qwen, prompts, 12, **geom)
    got, srv = _serve(qwen, prompts, 12, spec_decode=True, spec_k=3, **geom)
    want, jsrv = _serve(qwen, prompts, 12, side="jax", spec_decode=True,
                        spec_k=3, **geom)
    assert srv.metrics()["preemptions"] > 0
    assert got == ref == want
    assert _counters(srv) == _counters(jsrv)


def test_spec_griffin_window_family():
    """Griffin reduced to attention blocks (every cache leaf paged)
    speculates through the windowed multi-query K4 path: streams equal plain
    decoding's and JAX's."""
    jcfg, cfg = _pair("recurrentgemma-9b")
    jcfg = jcfg.replace(griffin=dc_replace(jcfg.griffin, pattern=("attn",)))
    cfg = cfg.replace(griffin=dc_replace(cfg.griffin, pattern=("attn",)))
    params = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    model = (jcfg, cfg, params)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (8, 16)]
    base = dict(num_slots=2, block_size=8, num_blocks=17, max_blocks_per_slot=4)
    ref, srv = _serve(model, prompts, 8, **base)
    assert all(lm.tree_leaves(srv.kv.paged))
    got, spec = _serve(model, prompts, 8, spec_decode=True, spec_k=3, **base)
    want, _ = _serve(model, prompts, 8, side="jax", spec_decode=True, spec_k=3,
                     **base)
    assert got == ref == want
    assert spec.metrics()["spec_proposed"] > 0


def test_spec_rejects_state_family_and_gathered(qwen):
    _, cfg, params = qwen
    _, rcfg = _pair("rwkv6-3b")
    rparams = lm.init(rcfg, seed=0, device="cpu")
    scfg = dict(num_slots=2, block_size=8, num_blocks=17,
                max_blocks_per_slot=4, spec_decode=True)
    with pytest.raises(ValueError, match="attention-only"):
        MegaServe(rcfg, rparams, ServeConfig(**scfg), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        MegaServe(cfg, from_jax_params(params, device="cpu"),
                  ServeConfig(**scfg, decode_path="gathered"), device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        MegaServe(cfg, from_jax_params(params, device="cpu"),
                  ServeConfig(**{**scfg, "spec_k": 0}), device="cpu")


def test_spec_adversarial_drafter_adapts_off(qwen):
    """An always-wrong drafter changes no token, and the per-request draft
    length adapts to 0 (plain decode ticks resume), with JAX's counts."""
    rng = np.random.default_rng(11)
    prompt = rng.integers(2, qwen[1].vocab_size, size=16).tolist()
    base = dict(num_slots=2, block_size=8, num_blocks=33, max_blocks_per_slot=8)
    ref, _ = _serve(qwen, [prompt], 24, **base)
    geom = dict(base, spec_decode=True, spec_k=4, spec_retry=64)
    drafter = RandomDrafter(qwen[1].vocab_size, seed=0)
    got, spec = _serve(qwen, [prompt], 24, drafter=drafter, **geom)
    want, jspec_srv = _serve(qwen, [prompt], 24, side="jax", drafter=drafter, **geom)
    assert got == ref == want
    assert spec.sched.requests[0].draft_len == 0
    assert spec.metrics()["spec_accept_rate"] < 0.2
    assert _counters(spec) == _counters(jspec_srv)
    assert any(e.name == "decode" for e in spec.trace_events())


def test_spec_eos_mid_acceptance_stops_stream(qwen):
    """An eos inside an accepted draft run cuts the stream at the eos, as
    without speculation."""
    rng = np.random.default_rng(4)
    prompt = rng.integers(2, qwen[1].vocab_size, size=16).tolist()
    base = dict(num_slots=2, block_size=8, num_blocks=33, max_blocks_per_slot=8)
    ref = _serve(qwen, [prompt], 16, **base)[0][0]
    eos = ref[7]
    want = ref[: ref.index(eos) + 1]
    for spec_on in (False, True):
        got, _ = _serve(qwen, [prompt], 16, eos_id=eos, spec_decode=spec_on,
                        spec_k=4, **base)
        assert got[0] == want, f"spec_decode={spec_on}"
