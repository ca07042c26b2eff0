"""MegaScope on the port against ``repro.core.scope`` on the CPU, in float32:
the compressors, the captures ``loss_fn`` returns for qwen2, rwkv6 and
recurrentgemma smoke models (keys, ``[n_groups]`` shapes, values), the
deterministic perturbations' losses, the gaussian draw (its scale, one draw
shared by a segment's layers, the same noise in a remat recompute), the bit
flips' rate, the dense cached attention, ``generate_with_scope`` and the
dashboard.

Both sides get the same weights (JAX ``lm.init`` with norm scales and QKV
biases redrawn from numpy) and the same numpy batch.  At float32 the
frameworks differ only in the order of float32 sums: losses agree to 1e-5
relative, captures to 1e-5 of each leaf's largest entry (CAP_TOL).
Random draws are each framework's own, so the gaussian, bitflip and
zero_mask tests hold statistics and invariants, not values.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import scope as jscope  # noqa: E402
from repro.core.scope import compress as jcompress  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import scope  # noqa: E402
from repro_torch.core.scope import compress  # noqa: E402
from repro_torch.core.scope.collector import _bitflip  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.weights import from_jax_params  # noqa: E402
from repro_torch.train import optim  # noqa: E402

LOSS_RTOL = 1e-5
CAP_TOL = 1e-5
COMPRESS_TOL = 1e-6


def _cfgs(arch, **kw):
    kw.setdefault("compute_dtype", "float32")
    return (jax_get_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def _jax_params(cfg, seed=0):
    params = jax.tree.map(np.asarray, jlm.init(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)

    def redraw(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                redraw(v)
            elif k in ("scale", "bq", "bk", "bv", "b_a", "b_i", "conv_b"):
                base = 1.0 if k == "scale" else 0.0
                tree[k] = (base + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)

    redraw(params)
    for blk in params["seg0"].values():
        if "att" in blk:  # rwkv6: milder decays, as tests/test_torch_rwkv.py
            blk["att"]["w_decay2"] = (0.5 * blk["att"]["w_decay2"]).astype(np.float32)
    return params


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _jax_loss(jcfg, params, batch, collector=None):
    args = (jcfg, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    if collector is None:
        return jlm.loss_fn(*args)
    return jlm.loss_fn(*args, collector)


def _port_loss(cfg, params, batch, collector=None):
    tp = from_jax_params(params, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        if collector is None:
            return lm.loss_fn(cfg, tp, tb)
        return lm.loss_fn(cfg, tp, tb, collector)


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def _assert_tree_close(ours, ref, tol):
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert set(ours) == set(ref)
    for path, v in ours.items():
        a = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        b = np.asarray(ref[path])
        assert a.shape == b.shape, path
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        else:
            scale = max(float(np.abs(b).max()), 1.0) if b.size else 1.0
            assert np.abs(a - b).max() <= tol * scale, path


# ------------------------------------------------------------- compress ---


def _compress_input():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 8, 16)) * 4).astype(np.float32)
    x.flat[:5] = [-8.0, 8.0, 0.0, 0.5, -9.5]   # edges, zero, out of range
    return x


@pytest.mark.parametrize("name", list(jcompress.COMPRESSORS))
def test_compressors_match_jax(name):
    x = _compress_input()
    ours = compress.COMPRESSORS[name](torch.from_numpy(x))
    ref = jcompress.COMPRESSORS[name](jnp.asarray(x))
    _assert_tree_close(ours if isinstance(ours, dict) else {"v": ours},
                       ref if isinstance(ref, dict) else {"v": ref}, COMPRESS_TOL)


def test_histogram_counts_and_edges_are_exact_in_bfloat16():
    x = _compress_input()
    ours = compress.histogram(torch.from_numpy(x).to(torch.bfloat16), bins=16)
    ref = jcompress.histogram(jnp.asarray(x, jnp.bfloat16), bins=16)
    np.testing.assert_array_equal(ours["hist"].numpy(), np.asarray(ref["hist"]))
    np.testing.assert_array_equal(ours["edges"].numpy(), np.asarray(ref["edges"]))
    assert ours["hist"].dtype == torch.int32 and int(ours["hist"].sum()) == x.size


def test_stats_leave_their_input_alone():
    x = torch.from_numpy(_compress_input())
    before = x.clone()
    compress.stats_of(x)
    assert torch.equal(x, before)


def test_stats_of_bfloat16_match_jax_at_the_sparsity_threshold():
    """bf16's nearest value to 1e-6 lies below it: JAX counts it sparse
    (its comparison is float32), so the port must too."""
    x = _compress_input()
    x.flat[5:9] = [1.046875 * 2.0 ** -20, -1.046875 * 2.0 ** -20, 1e-7, 2e-6]
    ours = compress.stats_of(torch.from_numpy(x).to(torch.bfloat16))
    ref = jcompress.stats_of(jnp.asarray(x, jnp.bfloat16))
    _assert_tree_close(ours, ref, COMPRESS_TOL)
    assert float(ours["sparsity"]) == 4 / x.size


# --------------------------------------------------------------- capture ---

PROBES = {
    "qwen2-0.5b": ["mlp_hidden:stats", "att_resid:stats", "q:channels",
                   "k:sample", "v:stats", "attn_probs:stats", "attn_out:stats",
                   "ffn_resid:full", "embeddings:stats", "final_hidden:stats"],
    "rwkv6-3b": ["wkv_decay:stats", "wkv_out:stats", "att_resid:channels",
                 "ffn_resid:stats", "final_hidden:stats"],
    "recurrentgemma-9b": ["rglru_decay:stats", "rglru_out:stats", "q:channels",
                          "att_resid:stats", "mlp_hidden:sample"],
}


def _specs(strings, module):
    out = []
    for s in strings:
        pattern, _, comp = s.partition(":")
        out.append(module.ProbeSpec(pattern, comp))
    return out


@pytest.mark.parametrize("arch", list(PROBES))
def test_captures_match_jax(arch):
    """Keys, ``[n_groups]`` leading axes and values of every capture, the
    ``seg{i}`` / ``top`` grouping and the ``b{j}/`` prefixes of multi-block
    segments, as JAX ``loss_fn`` returns them (seq 32: the naive attention
    branch, where ``attn_probs`` exists)."""
    jcfg, cfg = _cfgs(arch)
    params = _jax_params(jcfg)
    batch = _batch(cfg, 2, 32, seed=3)
    jl, jm = _jax_loss(jcfg, params, batch, jscope.ScopeCollector(
        probes=_specs(PROBES[arch], jscope)))
    loss, m = _port_loss(cfg, params, batch, scope.ScopeCollector(
        probes=_specs(PROBES[arch], scope)))
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    caps, jcaps = m["captures"], jax.tree.map(np.asarray, jm["captures"])
    assert set(caps) == set(jcaps)
    for seg in caps:
        assert set(caps[seg]) == set(jcaps[seg]), seg
    _assert_tree_close(caps, jcaps, CAP_TOL)
    n_groups = {f"seg{i}": n for i, (_, n) in enumerate(lm.segment_layout(cfg))}
    for seg, tree in caps.items():
        for path, leaf in _leaves(tree):
            if seg != "top":
                assert leaf.shape[0] == n_groups[seg], (seg, path)
            assert torch.isfinite(leaf.float()).all()


def test_probes_leave_the_loss_and_its_gradients_alone():
    """Probes never change numerics (JAX ``test_app`` asks the same)."""
    _, cfg = _cfgs("qwen2-0.5b")
    params = lm.init(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 48, 1).items()}
    flat = [p.requires_grad_(True) for _, p in optim.leaves(params)]
    results = []
    for col in (None, scope.ScopeCollector(probes=_specs(PROBES["qwen2-0.5b"], scope))):
        loss, m = lm.loss_fn(cfg, params, batch) if col is None else \
            lm.loss_fn(cfg, params, batch, col)
        results.append((loss.detach(), torch.autograd.grad(loss, flat), m))
    (l0, g0, m0), (l1, g1, m1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert "captures" not in m0 and "captures" in m1


@pytest.mark.parametrize("collector", ["null", "empty", "perturb-only"])
def test_no_probes_means_no_captures(collector):
    jcfg, cfg = _cfgs("qwen2-0.5b")
    params = _jax_params(jcfg)
    batch = _batch(cfg, 2, 32, seed=2)
    cols = {"null": (None, None),
            "empty": (jscope.ScopeCollector(), scope.ScopeCollector()),
            "perturb-only": (
                jscope.ScopeCollector(perturbs=[jscope.PerturbSpec("ffn_resid", "offset", 0.5)]),
                scope.ScopeCollector(perturbs=[scope.PerturbSpec("ffn_resid", "offset", 0.5)]))}
    jcol, col = cols[collector]
    _, jm = _jax_loss(jcfg, params, batch, jcol)
    _, m = _port_loss(cfg, params, batch, col)
    assert "captures" not in jm and "captures" not in m


# -------------------------------------------------------------- perturb ----

DETERMINISTIC = {
    "offset-all": ("ffn_resid", "offset", 1.0, None),
    "offset-layer0": ("ffn_resid", "offset", 1.0, 0),
    "offset-layer99": ("ffn_resid", "offset", 1.0, 99),
    "zero_mask-0": ("mlp_hidden", "zero_mask", 0.0, None),
    "zero_mask-1": ("mlp_hidden", "zero_mask", 1.0, None),
    "bitflip-0": ("att_resid", "bitflip", 0.0, None),
    "attn_uniform": ("attn_probs", "attn_uniform", 0.5, None),
}


@pytest.mark.parametrize("case", list(DETERMINISTIC))
def test_deterministic_perturbations_match_jax(case):
    pattern, kind, amount, layer = DETERMINISTIC[case]
    jcfg, cfg = _cfgs("qwen2-0.5b")
    params = _jax_params(jcfg)
    batch = _batch(cfg, 2, 32, seed=4)
    base, _ = _port_loss(cfg, params, batch)
    jl, _ = _jax_loss(jcfg, params, batch, jscope.ScopeCollector(
        perturbs=[jscope.PerturbSpec(pattern, kind, amount, layer)]))
    loss, _ = _port_loss(cfg, params, batch, scope.ScopeCollector(
        perturbs=[scope.PerturbSpec(pattern, kind, amount, layer)]))
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    moved = abs(loss.item() - base.item()) > 1e-4
    identity = case in ("offset-layer99", "zero_mask-0", "bitflip-0")
    assert moved != identity, (case, loss.item(), base.item())
    if identity:
        assert loss.item() == base.item()


def _zero_wo(params):
    """qwen2 smoke weights with the attention output projection at zero: the
    attention block's output, so each layer's pre-noise ``att_resid``, is
    exactly 0 whatever came before."""
    params["seg0"]["b0"]["attn"]["wo"] = np.zeros_like(params["seg0"]["b0"]["attn"]["wo"])
    return params


def test_gaussian_noise_scale_and_one_draw_per_site_as_jax():
    amount = 0.1
    jcfg, cfg = _cfgs("qwen2-0.5b")
    params = _zero_wo(_jax_params(jcfg))
    batch = _batch(cfg, 2, 32, seed=6)
    base, _ = _port_loss(cfg, params, batch)
    probe = "att_resid"
    _, jm = _jax_loss(jcfg, params, batch, jscope.ScopeCollector(
        probes=[jscope.ProbeSpec(probe, "full")],
        perturbs=[jscope.PerturbSpec(probe, "gaussian", amount)]))
    loss, m = _port_loss(cfg, params, batch, scope.ScopeCollector(
        probes=[scope.ProbeSpec(probe, "full")],
        perturbs=[scope.PerturbSpec(probe, "gaussian", amount)]))
    jnoise = np.asarray(jm["captures"]["seg0"][f"{probe}.full"])
    noise = m["captures"]["seg0"][f"{probe}.full"].numpy()
    # the pre-noise value is 0, so the capture is the noise: one draw shared
    # by both layers in JAX's scan, and in the port
    np.testing.assert_array_equal(jnoise[0], jnoise[1])
    np.testing.assert_array_equal(noise[0], noise[1])
    assert abs(noise.std() - amount) <= 0.05 * amount
    assert abs(noise.mean()) <= 0.05 * amount
    assert abs(loss.item() - base.item()) > 1e-4


def _grads(cfg, params, batch, col=None):
    flat = [p.requires_grad_(True) for _, p in optim.leaves(params)]
    loss, _ = (lm.loss_fn(cfg, params, batch) if col is None
               else lm.loss_fn(cfg, params, batch, col))
    return loss.detach(), torch.autograd.grad(loss, flat)


@pytest.mark.parametrize("kind,amount", [("gaussian", 0.3), ("zero_mask", 0.5)])
def test_recompute_under_remat_full_gets_the_forward_noise(kind, amount):
    """Remat ``"full"`` recomputes each layer in the backward, which tags
    again: the recompute must perturb with the forward's very draw and
    record nothing.  So the gradients equal remat ``"none"``'s, and after
    the backward the collector holds no capture."""
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = get_config("qwen2-0.5b", smoke=True).replace(
            compute_dtype="float32", remat=remat)
        params = lm.init(cfg, seed=0, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 48, 7).items()}
        col = scope.ScopeCollector(
            probes=[scope.ProbeSpec("mlp_hidden", "stats")],
            perturbs=[scope.PerturbSpec("att_resid", kind, amount),
                      scope.PerturbSpec("mlp_hidden", kind, amount)])
        out[remat] = _grads(cfg, params, batch, col)
        assert col.drain() == {}
    base_cfg = get_config("qwen2-0.5b", smoke=True).replace(compute_dtype="float32")
    clean = _grads(base_cfg, lm.init(base_cfg, seed=0, device="cpu"),
                   {k: torch.from_numpy(v) for k, v in _batch(base_cfg, 2, 48, 7).items()})
    assert clean[0].item() != out["none"][0].item()
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.allclose(a, b, rtol=1e-6, atol=1e-7), remat


def test_gaussian_draw_repeats_per_step_and_renews_per_call():
    _, cfg = _cfgs("qwen2-0.5b")
    params = lm.init(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 32, 8).items()}
    col = scope.ScopeCollector(perturbs=[scope.PerturbSpec("ffn_resid", "gaussian", 0.2)])
    with torch.no_grad():
        a = lm.loss_fn(cfg, params, batch, col)[0]
        b = lm.loss_fn(cfg, params, batch, col)[0]
        col.new_draws()
        c = lm.loss_fn(cfg, params, batch, col)[0]
        other = lm.loss_fn(cfg, params, batch, scope.ScopeCollector(
            perturbs=col.perturbs, seed=1))[0]
    assert torch.equal(a, b)
    assert a.item() != c.item() and a.item() != other.item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bitflip_rate(dtype):
    nbits = 32 if dtype == torch.float32 else 16
    x = torch.zeros((64, 64), dtype=dtype)
    y = _bitflip(x, 0.01, torch.Generator().manual_seed(0))
    bits = y.view(torch.int32 if nbits == 32 else torch.int16).numpy()
    n_flipped = np.unpackbits(bits.view(np.uint8)).sum()
    expect = 64 * 64 * nbits * 0.01
    assert 0.5 * expect < n_flipped < 1.5 * expect
    # JAX's rate on the same shape lies in the same band
    jy = jscope.collector._bitflip(jnp.zeros((64, 64), jnp.float32), 0.01,
                                   jax.random.PRNGKey(0))
    jn = np.unpackbits(np.asarray(jax.lax.bitcast_convert_type(jy, jnp.uint32)).view(np.uint8)).sum()
    assert 0.5 * 64 * 64 * 32 * 0.01 < jn < 1.5 * 64 * 64 * 32 * 0.01


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bitflip_zero_prob_is_the_identity_bit_for_bit(dtype):
    x = torch.randn((8, 8), generator=torch.Generator().manual_seed(1)).to(dtype)
    y = _bitflip(x, 0.0, torch.Generator().manual_seed(2))
    idt = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(y.view(idt), x.view(idt))


# ------------------------------------------------- dense cached attention ---


@pytest.mark.parametrize("window", [None, 40])
def test_dense_cached_attention_matches_jax(window):
    """T > kv_chunk with a ``kv_len``: JAX's chunked online softmax
    (``_make_flash``), plain PyTorch in the port; T is no multiple of the
    chunk (JAX pads, the port slices)."""
    rng = np.random.default_rng(9)
    B, S, H, K, D, T, chunk, kv_len = 2, 5, 4, 2, 16, 100, 32, 70
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, K, D)).astype(np.float32)
    v = rng.standard_normal((B, T, K, D)).astype(np.float32)
    pos = np.arange(kv_len - S, kv_len)
    kw = dict(scale=0.25, causal=True, window=window, impl="chunked", kv_chunk=chunk)
    ref = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       positions_q=jnp.asarray(pos), kv_len=jnp.int32(kv_len), **kw)
    ours = L.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                       positions_q=torch.from_numpy(pos), kv_len=kv_len, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ generation ---


def _jax_greedy(jcfg, params, prompt, n_steps, col, top_k=8):
    """JAX ``generate_with_scope`` with the chosen token fed back each step
    (ROADMAP R6): the same cache, forwards and records."""
    B, S = prompt.shape
    cache = jlm.init_cache(jcfg, B, S + n_steps)
    hidden, cache, aux = jlm.forward(jcfg, params, {"tokens": prompt}, cache=cache,
                                     cache_pos=jnp.int32(0), collector=col)
    logits = JL.logits_fn(params, jcfg, hidden[:, -1:, :])[:, 0]
    out = []
    for i in range(n_steps):
        tok = jnp.argmax(logits, -1)
        probs = jax.nn.softmax(logits.astype(jnp.float32), -1)
        tk_p, tk_i = jax.lax.top_k(probs[0], top_k)
        caps = jax.tree.map(np.asarray, jscope.generation._flat_captures(aux))
        out.append((int(tok[0]), float(probs[0, tok[0]]), np.asarray(tk_i),
                    np.asarray(tk_p), caps))
        hidden, cache, aux = jlm.forward(jcfg, params, {"tokens": tok.reshape(-1, 1)},
                                         cache=cache, cache_pos=jnp.int32(S + i),
                                         collector=col)
        logits = JL.logits_fn(params, jcfg, hidden)[:, 0]
    return out


GEN_PROBES = ["final_hidden:stats", "attn_probs:stats", "k:channels"]


def test_generation_matches_jax_greedy():
    """A 40-token prompt (over the smoke kv_chunk of 32: the prefill takes
    the chunked cached branch, each step the naive one), 6 steps: tokens and
    top-k equal, probabilities within 1e-5, captures within CAP_TOL."""
    jcfg, cfg = _cfgs("qwen2-0.5b")
    params = _jax_params(jcfg)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 40)).astype(np.int32)
    ref = _jax_greedy(jcfg, jax.tree.map(jnp.asarray, params), jnp.asarray(prompt), 6,
                      jscope.ScopeCollector(probes=_specs(GEN_PROBES, jscope)))
    records, toks = scope.generate_with_scope(
        cfg, from_jax_params(params, device="cpu"), torch.from_numpy(prompt).long(), 6,
        scope.ScopeCollector(probes=_specs(GEN_PROBES, scope)))
    assert toks.shape == (1, 6) and toks[0].tolist() == [r.token for r in records]
    for r, (tok, prob, tk_i, tk_p, caps) in zip(records, ref):
        assert r.token == tok
        assert r.topk_tokens == tk_i.tolist()
        np.testing.assert_allclose(r.topk_probs, tk_p, atol=1e-5)
        assert abs(r.prob - prob) <= 1e-5
        _assert_tree_close(r.captures, caps, CAP_TOL)
    # the prefill has no probabilities to capture (chunked branch); steps do
    assert "attn_probs.stats" not in records[0].captures
    assert "attn_probs.stats" in records[1].captures


def test_generation_first_step_equals_jax_generate_with_scope():
    """JAX's own ``generate_with_scope`` agrees on the first step; it then
    feeds that first token again at every step (ROADMAP R6), where the port
    feeds each step's choice."""
    jcfg, cfg = _cfgs("qwen2-0.5b")
    params = _jax_params(jcfg)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    jrec, jtoks = jscope.generate_with_scope(jcfg, jax.tree.map(jnp.asarray, params),
                                             jnp.asarray(prompt), 3)
    records, toks = scope.generate_with_scope(
        cfg, from_jax_params(params, device="cpu"), torch.from_numpy(prompt).long(), 3)
    assert records[0].token == jrec[0].token
    assert records[0].topk_tokens == jrec[0].topk_tokens
    assert abs(records[0].prob - jrec[0].prob) <= 1e-5
    assert np.asarray(jtoks)[0].tolist() == [jrec[0].token] * 3


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_generation_over_a_carried_state_is_refused(arch):
    """Refused until the recurrent serving slice, now ported: over the
    recurrent families' carried state (and Griffin's windowed KV cache) a
    36-token prompt and 6 steps (past Griffin's smoke window of 32) give
    JAX's tokens and top-k and its probabilities within 1e-5, held to a JAX
    loop with each step's token fed back and, on the first step, to JAX's
    own ``generate_with_scope`` (R6)."""
    jcfg, cfg = _cfgs(arch)
    params = _jax_params(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 36)).astype(np.int32)
    probes = ["final_hidden:stats"]
    ref = _jax_greedy(jcfg, jp, jnp.asarray(prompt), 6,
                      jscope.ScopeCollector(probes=_specs(probes, jscope)))
    records, toks = scope.generate_with_scope(
        cfg, from_jax_params(params, device="cpu"), torch.from_numpy(prompt).long(), 6,
        scope.ScopeCollector(probes=_specs(probes, scope)))
    assert toks[0].tolist() == [r.token for r in records] == [t for t, *_ in ref]
    for r, (tok, prob, tk_i, tk_p, caps) in zip(records, ref):
        assert r.topk_tokens == tk_i.tolist()
        np.testing.assert_allclose(r.topk_probs, tk_p, atol=1e-5)
        assert abs(r.prob - prob) <= 1e-5
        _assert_tree_close(r.captures, caps, CAP_TOL)
    jrec, _ = jscope.generate_with_scope(jcfg, jp, jnp.asarray(prompt), 1)
    assert records[0].token == jrec[0].token
    assert records[0].topk_tokens == jrec[0].topk_tokens


# ------------------------------------------------------- pca, dashboard ---


def test_pca_matches_jax():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(64,))
    d /= np.linalg.norm(d)
    x = rng.normal(size=(200, 1)) * 5 @ d[None, :] + rng.normal(size=(200, 64)) * 0.1
    fit, jfit = scope.pca_fit(x, k=2), jscope.pca_fit(x, k=2)
    assert abs(fit["components"][0] @ d) > 0.98
    np.testing.assert_array_equal(fit["components"], jfit["components"])
    np.testing.assert_array_equal(scope.pca_project(x, fit), jscope.pca_project(x, jfit))


def test_dashboard_holds_its_markers_and_equals_jax(tmp_path):
    _, cfg = _cfgs("qwen2-0.5b")
    params = lm.init(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 8)))
    records, _ = scope.generate_with_scope(
        cfg, params, prompt, 4, scope.ScopeCollector(probes=_specs(GEN_PROBES, scope)))
    hidden = np.stack([r.captures["final_hidden.stats"]["mean"] for r in records])
    kw = dict(attention=records[-1].captures["attn_probs.stats"]["max"].reshape(-1, 1)
              @ np.ones((1, 4), np.float32),
              pca_points=np.c_[hidden, hidden ** 2], meta="qwen2-0.5b-smoke")
    ours = scope.write_dashboard(tmp_path / "ours.html", records, **kw).read_text()
    ref = jscope.write_dashboard(tmp_path / "ref.html", records, **kw).read_text()
    assert "MegaScope dashboard" in ours and "const DATA" in ours and len(ours) > 2000
    assert ours == ref
