"""Serving the recurrent families (RWKV-6, Griffin) in the port against the
JAX package on the CPU, in float32: the carried-state recurrences, the
layer states, the dense cached forward over pow2 segments, the pool's two
leaf kinds and ``scatter_prefill``, ``pow2_segments``, MegaServe's greedy
streams (token-identical to JAX ``MegaServe``), the CLI, the bfloat16 cast
of the serving weights, and K3's plain version at head dim 256 under a
window.

Weights are JAX ``lm.init`` on the smoke configs (``PRNGKey(0)``),
converted by ``models/weights.py``; inputs are numpy draws from a seed.
Float32 sums are grouped as JAX groups them where the code copies JAX's
(the associative scans), elsewhere in another order: outputs agree to
``TOL`` of each output's largest magnitude.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.app import cli as jcli  # noqa: E402
from repro.app.session import Session as JSession  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.paged_attention.ops import paged_attention as jpaged_attention  # noqa: E402
from repro.models import griffin as jgriffin  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import scan_utils as jscan  # noqa: E402
from repro.serve import MegaServe as JaxMegaServe  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve.paged_cache import PagedKVCache as JPagedKVCache  # noqa: E402
from repro.serve.paged_cache import PoolSpec as JPoolSpec  # noqa: E402
from repro_torch.app import cli  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_plain  # noqa: E402
from repro_torch.models import griffin, lm, rwkv, scan_utils  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.weights import from_jax_params  # noqa: E402
from repro_torch.serve import MegaServe, ServeConfig  # noqa: E402
from repro_torch.serve.paged_cache import PagedKVCache, PoolSpec, pow2_segments  # noqa: E402

ARCHS = ("rwkv6-3b", "recurrentgemma-9b")
# float32 on both sides: errors relative to each output's largest magnitude
TOL = 2e-5
# Griffin's attention cache is bfloat16 on both sides: a K or V entry that
# the two sides' float32 products (sums in another order, ~1e-7 apart) put
# on either side of a bfloat16 rounding boundary is stored one bfloat16 ulp
# apart (2^-8 of it).  On this seed 2 of 1280 V entries flip, which moves
# later positions' logits and the next layer's state by up to 1.1e-4 of
# their largest entry; the limit is 1e-3 of it, and the cache's own k/v
# are held within one bfloat16 ulp of their largest entry (2^-7)
CACHED_TOL = {"rwkv6-3b": TOL, "recurrentgemma-9b": 1e-3}
BF16_ULP = 2.0 ** -7
# the bf16 forward over the cast tree: both sides round to bfloat16 at the
# same places, but every product sums in another order and flips roundings
# that compound through the layers: at this seed JAX's bfloat16 logits stand
# 0.19 from its float32 logits, the port's 0.18, and the two 0.11 apart
# (logits O(1) to 4, where a bfloat16 ulp is 2^-6).  The port must stand no
# further from the float32 logits than 1.25 times JAX's distance, and within
# 0.25 (chip_smoke.py's LOGIT_TOL) of JAX's bfloat16 logits
BF16_LOGIT_TOL = 0.25


def _close(ours, ref, tol=TOL):
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(ours - ref).max())
    assert err <= tol * scale, (err, scale)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(arch, JAX config, port config, JAX float32 parameters as numpy)."""
    arch = request.param
    jcfg = jax_get_config(arch, smoke=True).replace(compute_dtype="float32")
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
    params = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    return arch, jcfg, cfg, params


# ------------------------------------------------------------ recurrences


def _wkv_inputs(S, seed):
    rng = np.random.default_rng(seed)
    B, H, N = 2, 3, 8
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32) for _ in range(3))
    # decays from brutal (exp(-4), clamped by the chunk form) to long memory
    w = np.exp(-np.exp(rng.uniform(-6.0, 1.4, (B, S, H, N)))).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("S", [64, 13])
@pytest.mark.parametrize("form", ["sequential", "chunked"])
def test_wkv6_with_a_state_matches_jax(form, S):
    """At S = 13 the chunked form falls back to the sequential one, as
    JAX's does; at S = 64 it runs two clamped chunks."""
    args = _wkv_inputs(S, seed=S)
    jfn = getattr(jscan, f"wkv6_{form}")
    tfn = getattr(scan_utils, f"wkv6_{form}")
    y_ref, s_ref = jfn(*_j(*args))
    y, s = tfn(*_t(*args))
    _close(y, y_ref)
    _close(s, s_ref)


@pytest.mark.parametrize("S", [256, 100, 130])
@pytest.mark.parametrize("with_h0", [True, False])
def test_lru_scan_matches_jax(S, with_h0):
    """JAX's chunk rule: two levels of 128 at S = 256, one chunk of 100,
    and one level over 130."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 24)).astype(np.float32)
    b = rng.standard_normal((2, S, 24)).astype(np.float32)
    h0 = rng.standard_normal((2, 24)).astype(np.float32) if with_h0 else None
    h_ref, last_ref = jscan.lru_scan(jnp.asarray(a), jnp.asarray(b),
                                     None if h0 is None else jnp.asarray(h0))
    h, last = scan_utils.lru_scan(*_t(a, b), None if h0 is None else torch.from_numpy(h0))
    _close(h, h_ref)
    _close(last, last_ref)


@pytest.mark.parametrize("S", [1, 2, 17])
def test_causal_conv1d_with_a_context_matches_jax(S):
    """``y`` and ``new_prev``, including ``S < width - 1`` (context rows
    carried into the new context)."""
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    prev = rng.standard_normal((2, 3, 16)).astype(np.float32)
    y_ref, p_ref = jscan.causal_conv1d(*_j(x, w, bias, prev))
    y, p = scan_utils.causal_conv1d(*_t(x, w, bias, prev))
    _close(y, y_ref)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))


# ------------------------------------------------------------ states


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def test_init_states_match_jax():
    jcfg, cfg = (jax_get_config("rwkv6-3b", smoke=True), get_config("rwkv6-3b", smoke=True))
    assert _shapes(rwkv.rwkv_init_state(cfg, 3)) == _shapes(jrwkv.rwkv_init_state(jcfg, 3))
    jcfg = jax_get_config("recurrentgemma-9b", smoke=True)
    cfg = get_config("recurrentgemma-9b", smoke=True)
    for kind in ("rec", "attn"):
        assert (_shapes(griffin.griffin_init_state(cfg, kind, 2, 40))
                == _shapes(jgriffin.griffin_init_state(jcfg, kind, 2, 40)))
    assert _shapes(griffin.griffin_init_state(cfg, "rec", 1, 8))["h"][1] == "float32"


# ------------------------------------------------------ the cached forward


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_cached_forward_over_two_segments_matches_jax(family):
    """Two pow2 segments (32 then 8 tokens) into one dense cache of 48
    positions: 32 runs the clamped chunk WKV and Griffin's window-32
    attention across its chunked kv_len branch, 8 the exact sequential
    form; the logits of each and every cache leaf agree."""
    arch, jcfg, cfg, params = family
    tol = CACHED_TOL[arch]
    jp = jax.tree.map(jnp.asarray, params)
    tp = from_jax_params(params, device="cpu")
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, (1, 40)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, 1, 48)
    cache = lm.init_cache(cfg, 1, 48, device="cpu")
    for off, w in ((0, 32), (32, 8)):
        hid, jcache, _ = jlm.forward(jcfg, jp, {"tokens": jnp.asarray(toks[:, off:off + w])},
                                     cache=jcache, cache_pos=jnp.int32(off))
        ref = JL.logits_fn(jp, jcfg, hid)
        with torch.inference_mode():
            h, _ = lm.forward(cfg, tp, torch.from_numpy(toks[:, off:off + w]).long(),
                              cache=cache, cache_pos=off)
            _close(L.logits_fn(tp, cfg, h), ref, tol)
    ours = dict(_flat(cache))
    for path, leaf in _flat(jax.tree.map(np.asarray, jcache)):
        assert ours[path].dtype == {"bfloat16": torch.bfloat16}.get(
            str(leaf.dtype), torch.float32), path
        kv = path.endswith("/k") or path.endswith("/v")
        _close(ours[path], np.asarray(leaf, np.float32), BF16_ULP if kv else tol)


# ------------------------------------------------------------ the pool


def test_pool_flags_and_scatter_prefill_match_jax(family):
    _, jcfg, cfg, _ = family
    spec = dict(num_slots=3, num_blocks=9, block_size=8, max_blocks=4)
    jkv = JPagedKVCache(jcfg, JPoolSpec(**spec))
    kv = PagedKVCache(cfg, PoolSpec(**spec), torch.device("cpu"))
    assert kv.paged == jkv.paged
    assert _shapes(kv.pool) == _shapes(jax.tree.map(np.asarray, jkv.pool))
    # a filled one-row cache of 2 blocks (16 positions), random leaves
    rng = np.random.default_rng(7)
    template = jlm.init_cache(jcfg, 1, 16)
    filled = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32).astype(a.dtype),
        jax.tree.map(np.asarray, template))
    phys = np.asarray([5, 0], np.int32)   # one real block, one null padding
    jpool = jkv.scatter_prefill(jkv.pool, jax.tree.map(jnp.asarray, filled),
                                jnp.int32(2), jnp.asarray(phys))
    tfilled = from_jax_params(jax.tree.map(
        lambda a: np.asarray(a, np.float32) if a.dtype != np.float32 else a, filled),
        device="cpu")
    tfilled = lm.tree_map(lambda t, ref: t.to(ref.dtype), tfilled,
                          lm.init_cache(cfg, 1, 16, device="cpu"))
    kv.scatter_prefill(kv.pool, tfilled, 2, torch.from_numpy(phys))
    ours = dict(_flat(kv.pool))
    for path, leaf in _flat(jax.tree.map(np.asarray, jpool)):
        got = ours[path].float().numpy()
        want = np.asarray(leaf, np.float32)
        if kv.paged[path.split("/")[0]][path.split("/")[1]][path.split("/")[2]]:
            got, want = got[:, 1:], want[:, 1:]  # the null block's duplicate writes
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_pow2_segments():
    """As ``tests/test_flash_prefill.py`` holds the JAX function."""
    assert pow2_segments(13) == [8, 4, 1]
    assert pow2_segments(1) == [1]
    assert pow2_segments(64) == [64]
    assert sum(pow2_segments(100)) == 100
    assert pow2_segments(2047) == [1 << b for b in range(10, -1, -1)]
    with pytest.raises(ValueError):
        pow2_segments(0)


# ------------------------------------------------------------ MegaServe


def _serve_both(family, prompts, max_new, **geom):
    _, jcfg, cfg, params = family
    jsrv = JaxMegaServe(jcfg, jax.tree.map(jnp.asarray, params),
                        JaxServeConfig(paged_attn_impl="xla", **geom))
    srv = MegaServe(cfg, from_jax_params(params, device="cpu"),
                    ServeConfig(**geom), device="cpu")
    for s in (jsrv, srv):
        for p in prompts:
            s.submit(p, max_new)
    return jsrv.drain(), srv.drain(), jsrv, srv


@pytest.fixture(scope="module")
def served(family):
    """Prompts of 5, 13, 17 and 45 tokens (45 = 32 + 8 + 4 + 1: a clamped
    chunk segment, then exact ones), 24 new tokens each: Griffin's smoke
    window of 32 is passed by every stream's decode, the 45-token one's
    prefill too."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (5, 13, 17, 45)]
    return _serve_both(family, prompts, 24, num_slots=2, block_size=8,
                       num_blocks=40, max_blocks_per_slot=12)


def test_streams_match_jax(served):
    ref, got, jsrv, srv = served
    assert got == ref
    assert all(len(s) == 24 for s in got.values())
    assert srv.decode_path == jsrv.decode_path == "paged"
    assert srv.prefill_path == jsrv.prefill_path == "dense"
    assert srv._seg_ok and jsrv._seg_ok
    ev = [e.name for e in srv.trace_events()]
    assert ev.count("prefill") == 4 and "decode" in ev


def test_streams_match_jax_under_preemption(family):
    """7 usable blocks of 8 for three 20 + 16-token sequences: the pool runs
    dry, requests are preempted and re-prefilled through the segment
    driver from their prompt and generated tokens, and streams still
    match."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, 256, size=20).tolist() for _ in range(3)]
    ref, got, jsrv, srv = _serve_both(family, prompts, 16, num_slots=3,
                                      block_size=8, num_blocks=8,
                                      max_blocks_per_slot=5)
    assert srv.metrics()["preemptions"] > 0
    assert srv.metrics()["preemptions"] == jsrv.metrics()["preemptions"]
    assert got == ref


@pytest.mark.parametrize("knob,value,error", [
    ("spec_decode", True, "spec_decode needs an attention-only KV cache"),
    ("chunked_prefill", True, "chunked_prefill needs the paged decode path"),
    ("prefill_path", "flash", "prefill_path='flash' needs"),
])
def test_state_family_refusals_match_jax(family, knob, value, error):
    _, jcfg, cfg, params = family
    geom = dict(num_slots=2, block_size=8, num_blocks=17, max_blocks_per_slot=4)
    with pytest.raises(ValueError, match=error):
        JaxMegaServe(jcfg, jax.tree.map(jnp.asarray, params),
                     JaxServeConfig(**geom, **{knob: value}))
    with pytest.raises(ValueError, match=error):
        MegaServe(cfg, from_jax_params(params, device="cpu"),
                  ServeConfig(**geom, **{knob: value}), device="cpu")


def test_cli_serves_like_the_jax_session(family, monkeypatch):
    """``serve --arch ... --smoke --device cpu --continuous`` with the JAX
    Session's weights (``PRNGKey(0)``) handed to the port's ``lm.init``:
    the same workload, pool and token-identical streams at the smoke
    config's bfloat16."""
    arch = family[0]
    argv = ["serve", "--arch", arch, "--smoke", "--continuous", "--requests", "4",
            "--rate", "300", "--slots", "2", "--max-new", "6",
            "--prompt-lens", "5,13"]
    _, jrun = jcli._parse(argv)
    jsession = JSession(jrun)
    jouts, jmet = jsession.run()
    jparams = jax.tree.map(np.asarray, jlm.init(jsession.model_cfg, jax.random.PRNGKey(0)))
    # the Session draws serving weights in the compute dtype (``dtype``);
    # MegaServe casts the float32 JAX tree alike
    monkeypatch.setattr(lm, "init", lambda cfg, seed=0, device="cuda", dtype=None:
                        from_jax_params(jparams, device=device))
    out = cli.run([*argv, "--device", "cpu"])
    assert out["serve_config"] == {k: jsession.results["serve_config"][k]
                                   for k in out["serve_config"]}
    assert out["metrics"]["finished"] == 4 == jmet["finished"]
    assert out["metrics"]["generated_tokens"] == jmet["generated_tokens"]
    assert out["session"].results["prefill_path"] == "dense"
    assert out["streams"] == jouts


# -------------------------------------------------------- the bf16 cast


def test_cast_keeps_the_float32_leaves_and_the_bf16_forward_matches_jax():
    """``cast_params`` keeps what JAX takes in float32 uncast (``w0``,
    ``u``, ``w_decay2``, ``ln_x`` and the norms; Griffin's ``lam``); a
    bfloat16 rwkv6 forward over the cast tree, a 32-token segment then one
    token over a dense cache, agrees with JAX's bfloat16 forward over its
    float32 parameters as ``BF16_LOGIT_TOL`` says."""
    gcfg = get_config("recurrentgemma-9b", smoke=True)
    gp = lm.cast_params(lm.init(gcfg, seed=0, device="cpu"), torch.bfloat16,
                        torch.device("cpu"))
    assert gp["seg0"]["b0"]["mix"]["rglru"]["lam"].dtype == torch.float32
    assert gp["seg0"]["b0"]["mix"]["w_x"].dtype == torch.bfloat16
    jcfg = jax_get_config("rwkv6-3b", smoke=True)
    cfg = get_config("rwkv6-3b", smoke=True)
    assert jcfg.compute_dtype == cfg.compute_dtype == "bfloat16"
    params = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    tp = lm.cast_params(from_jax_params(params, device="cpu"), torch.bfloat16,
                        torch.device("cpu"))
    att = tp["seg0"]["b0"]["att"]
    for leaf in (att["w0"], att["u"], att["w_decay2"], att["ln_x"]["bias"],
                 att["ln_x"]["scale"], tp["seg0"]["b0"]["ln1"]["scale"]):
        assert leaf.dtype == torch.float32
    assert att["w_decay1"].dtype == att["w_r"].dtype == torch.bfloat16
    jp = jax.tree.map(jnp.asarray, params)
    toks = np.random.default_rng(5).integers(1, 256, (1, 33)).astype(np.int32)

    def run_jax(c):
        cache, out = jlm.init_cache(c, 1, 40), []
        for off, w in ((0, 32), (32, 1)):
            hid, cache, _ = jlm.forward(c, jp, {"tokens": jnp.asarray(toks[:, off:off + w])},
                                        cache=cache, cache_pos=jnp.int32(off))
            out.append(np.asarray(JL.logits_fn(jp, c, hid), np.float32)[..., :256])
        return np.concatenate(out, axis=1)

    ref, ref32 = run_jax(jcfg), run_jax(jcfg.replace(compute_dtype="float32"))
    cache, out = lm.init_cache(cfg, 1, 40, device="cpu"), []
    with torch.inference_mode():
        for off, w in ((0, 32), (32, 1)):
            h, _ = lm.forward(cfg, tp, torch.from_numpy(toks[:, off:off + w]).long(),
                              cache=cache, cache_pos=off)
            out.append(L.logits_fn(tp, cfg, h).float().numpy()[..., :256])
    ours = np.concatenate(out, axis=1)
    assert np.isfinite(ours).all()
    assert np.abs(ours - ref).max() <= BF16_LOGIT_TOL
    assert np.abs(ours - ref32).max() <= 1.25 * np.abs(ref - ref32).max()


# ----------------------------------------------------- K3 at head dim 256


@pytest.mark.parametrize("window", [None, 40])
def test_paged_attention_plain_at_head_dim_256_matches_jax(window):
    """recurrentgemma-9b's heads (16 query heads over one kv head of 256)
    through the block table, against JAX's Pallas kernel in interpret mode,
    with the window reaching back past split-sized spans of the table."""
    rng = np.random.default_rng(11)
    S, H, K, D, bs, M = 3, 16, 1, 256, 8, 12
    pools = [rng.standard_normal((2, 1 + S * M, bs, K, D)).astype(np.float32)
             .astype(jnp.bfloat16) for _ in range(2)]
    tables = (1 + np.arange(S * M, dtype=np.int32)).reshape(S, M)
    kv_len = np.asarray([1, 45, 96], np.int32)
    q = rng.standard_normal((S, 1, H, D)).astype(np.float32).astype(jnp.bfloat16)
    ref = jpaged_attention(*_j(q, *pools), tables=jnp.asarray(tables),
                           kv_len=jnp.asarray(kv_len), scale=D ** -0.5,
                           window=window, impl="pallas_interpret", layer=jnp.int32(1))
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)  # noqa: E731
    ours = paged_attention_plain(bf(q), bf(pools[0]), bf(pools[1]),
                                 torch.from_numpy(tables), torch.from_numpy(kv_len),
                                 scale=D ** -0.5, window=window, layer=1)
    # both round each entry to bfloat16 once: one ulp of the largest entry
    _close(ours, np.asarray(ref, np.float32), tol=2.0 ** -7)
