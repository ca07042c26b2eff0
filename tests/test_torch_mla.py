"""MLA (DeepSeek multi-head latent attention) and deepseek-v2-lite in the port
against the JAX package on the CPU, in float32, on the smoke config (3
layers: one dense, two MoE; 4 heads, q/k head dim 16 + 8 = 24, v head dim
16, latent rank 32, ``attn_kv_chunk`` 32).

The cases: the init tree (leaf paths and shapes equal JAX's ``lm.init``,
carried across by ``models.weights``; the cast-as-drawn init equal to the
cast one); ``mla_apply``'s full path, forward and every MLA leaf's gradient,
at seq 64 (past ``attn_kv_chunk``: the flash branch, K2's plain version at
(24, 16)) and seq 16 (the naive branch); a prefill then 4 absorbed decode
steps, layer by layer and through the whole model (outputs, the ``ckv`` /
``kpe`` cache leaves, one ``attn_probs`` capture); the smoke model's loss
and every gradient leaf with remat none and full; MegaServe's greedy streams
on the gathered path; the paged path and speculation refused as JAX refuses
them.

Tolerances: float32 on both sides differs only in the order of sums.
Outputs and captures within ``TOL`` (1e-5) of the largest entry of the
reference; the loss within ``LOSS_RTOL`` (2e-6) relative; gradient leaves
within ``GRAD_TOL`` (2e-5) of each leaf's largest entry.  The latent cache
is bfloat16 on both sides: each entry within one bfloat16 ulp (2^-8 of the
leaf's largest entry), as a float32 difference in the last bits can tip one
rounding.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import MegaServe as JaxMegaServe  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.hooks import Collector  # noqa: E402
from repro_torch.models.weights import from_jax_params  # noqa: E402
from repro_torch.serve import MegaServe, ServeConfig  # noqa: E402
from repro_torch.train import optim  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
TOL = 1e-5
LOSS_RTOL = 2e-6
GRAD_TOL = 2e-5
CACHE_RTOL = 2.0 ** -8


def _cfgs(**kw):
    kw.setdefault("compute_dtype", "float32")
    return (jax_get_config(ARCH, smoke=True).replace(**kw),
            get_config(ARCH, smoke=True).replace(**kw))


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = _cfgs()
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jlm.init(jcfg, k))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for seg in ("seg0", "seg1"):  # kv_norm away from its init of ones
        attn = params[seg]["b0"]["attn"]
        attn["kv_norm"] = (1 + 0.3 * rng.standard_normal(attn["kv_norm"].shape)
                           ).astype(np.float32)
    return jcfg, cfg, params


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), err


class _Tags(Collector):
    """Keeps every tag it sees (eager, outside any scan)."""

    def __init__(self):
        self.seen = {}

    def tag(self, name, x, **meta):
        self.seen[name] = x
        return x


def test_init_tree_and_cast_as_drawn_equal(smoke):
    """The port's tree has JAX's paths and shapes (``wq [D, H, 24]``, the
    latent ``wdkv``/``wkr``/``kv_norm``/``wuk``/``wuv``, ``wo [H, 16, D]``),
    JAX's values cross leaf by leaf, ``init(dtype=bf16)`` equals the float32
    init cast by ``cast_params`` (``kv_norm`` stays float32 in both)."""
    jcfg, cfg, params = smoke
    assert lm.segment_layout(cfg) == jlm.segment_layout(jcfg)
    ours = lm.init(cfg, seed=0, device="cpu")
    shapes = {p: tuple(v.shape) for p, v in optim.leaves(ours)}
    assert shapes == {p: tuple(v.shape) for p, v in optim.leaves(params)}
    m, H = cfg.mla, cfg.num_heads
    assert shapes[("seg1", "b0", "attn", "wq")] == (2, cfg.d_model, H, 24)
    assert shapes[("seg0", "b0", "attn", "wuv")] == (1, m.kv_lora_rank, H, m.v_head_dim)
    assert shapes[("seg1", "b0", "attn", "wo")] == (2, H, m.v_head_dim, cfg.d_model)
    crossed = from_jax_params(params, device="cpu")
    for path, v in optim.leaves(params):
        got = crossed
        for k in path:
            got = got[k]
        assert np.array_equal(got.numpy(), v), path
    cast = lm.cast_params(ours, torch.bfloat16, torch.device("cpu"))
    drawn = lm.init(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    for (path, a), (_, b) in zip(optim.leaves(cast), optim.leaves(drawn)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert cast["seg1"]["b0"]["attn"]["kv_norm"].dtype == torch.float32
    assert cast["seg1"]["b0"]["attn"]["wuk"].dtype == torch.bfloat16


def _layer_params(params, seg="seg1", g=0):
    return {k: np.array(v[g]) for k, v in params[seg]["b0"]["attn"].items()}


@pytest.mark.parametrize("S", [64, 16], ids=["flash", "naive"])
def test_mla_apply_full_path_and_grads_match_jax(smoke, S):
    """The full (training) path: output and the gradient of every MLA leaf
    and of the input against ``jax.vjp`` of JAX ``mla_apply``; at seq 64
    the port's attention takes the flash branch (K2's plain version, q/k
    at 24 and v at 16), which launches nothing on the CPU."""
    jcfg, cfg, params = smoke
    p = _layer_params(params)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)

    def f(pp, xx):
        return JL.mla_apply(pp, jcfg, xx, positions=jnp.arange(S))[0]

    want, (jgp, jgx) = jax.jit(lambda pp, xx, d: (
        f(pp, xx), jax.vjp(f, pp, xx)[1](d)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(dy))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    before = dict(flash_attention.launches)
    got = L.mla_apply(tp, cfg, tx, positions=torch.arange(S))
    grads = torch.autograd.grad(got, [*tp.values(), tx], torch.tensor(dy))
    assert flash_attention.launches == before
    _close(got.detach(), want)
    for name, g in zip(tp, grads):
        _close(g, jgp[name], GRAD_TOL)
    _close(grads[-1], jgx, GRAD_TOL)


def test_prefill_then_absorbed_decode_match_jax(smoke):
    """One MLA layer: a 20-token prefill into a 32-position latent cache
    (the padded ``ckv`` and ``kpe``), then 4 absorbed decode steps, each
    writing its latent at ``cache_pos`` and attending in the latent space:
    outputs, both cache leaves after every step and the last step's
    ``attn_probs`` against JAX's."""
    jcfg, cfg, params = smoke
    p = _layer_params(params, "seg0")
    m, T, P = cfg.mla, 32, 20
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((1, P + 4, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jcache = {"ckv": jnp.zeros((1, T, m.kv_lora_rank), jnp.bfloat16),
              "kpe": jnp.zeros((1, T, m.qk_rope_head_dim), jnp.bfloat16)}
    cache = lm.init_cache(cfg, 1, T, device="cpu")["seg0"]["b0"]
    cache = {k: v[0] for k, v in cache.items()}  # one layer's [1, T, w] views
    want, jcache = JL.mla_apply(jp, jcfg, jnp.asarray(xs[:, :P]), positions=jnp.arange(P),
                                cache=jcache, cache_pos=jnp.int32(0))
    got = L.mla_apply(tp, cfg, torch.tensor(xs[:, :P]), positions=torch.arange(P),
                      cache=cache, cache_pos=0)
    _close(got, want)
    for i in range(4):
        pos = P + i
        for k in ("ckv", "kpe"):
            _close(cache[k].float(), jnp.asarray(jcache[k], jnp.float32), CACHE_RTOL)
        jtags, tags = _Tags(), _Tags()
        want, jcache = JL.mla_apply(jp, jcfg, jnp.asarray(xs[:, pos:pos + 1]),
                                    positions=jnp.arange(pos, pos + 1), cache=jcache,
                                    cache_pos=jnp.int32(pos), collector=jtags)
        got = L.mla_apply(tp, cfg, torch.tensor(xs[:, pos:pos + 1]),
                          positions=torch.arange(pos, pos + 1), cache=cache,
                          cache_pos=pos, collector=tags)
        _close(got, want)
    assert tags.seen["attn_probs"].shape == (1, 1, cfg.num_heads, T)
    _close(tags.seen["attn_probs"], jtags.seen["attn_probs"])
    assert float(tags.seen["attn_probs"][..., P + 4:].abs().max()) == 0.0


def test_model_prefill_and_decode_match_jax(smoke):
    """The whole smoke model over the dense latent cache (``lm.init_cache``:
    ``ckv [n, B, T, 32]``, ``kpe [n, B, T, 8]`` a segment): JAX
    ``lm.prefill`` then ``lm.decode_step`` against ``lm.forward`` with
    ``cache``; logits after each step and every cache leaf at the end."""
    jcfg, cfg, params = smoke
    rng = np.random.default_rng(5)
    B, P, T = 2, 40, 48
    toks = rng.integers(0, cfg.vocab_size, (B, P + 4)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = from_jax_params(params, device="cpu")
    jcache, jlog = jax.jit(lambda p, b, c: jlm.prefill(jcfg, p, b, c))(
        jparams, {"tokens": jnp.asarray(toks[:, :P])}, jlm.init_cache(jcfg, B, T))
    decode = jax.jit(lambda p, c, t, pos: jlm.decode_step(jcfg, p, c, t, pos))
    cache = lm.init_cache(cfg, B, T, device="cpu")
    assert {p: tuple(v.shape) for p, v in optim.leaves(cache)} == {
        p: tuple(v.shape) for p, v in optim.leaves(jax.tree.map(np.asarray, jcache))}
    with torch.no_grad():
        h, _ = lm.forward(cfg, tparams, torch.tensor(toks[:, :P]), cache=cache, cache_pos=0)
        _close(L.logits_fn(tparams, cfg, h[:, -1:])[:, 0], jlog)
        for i in range(4):
            pos = P + i
            jcache, jlog = decode(jparams, jcache, jnp.asarray(toks[:, pos]),
                                  jnp.int32(pos))
            h, _ = lm.forward(cfg, tparams, torch.tensor(toks[:, pos:pos + 1]),
                              cache=cache, cache_pos=pos)
            _close(L.logits_fn(tparams, cfg, h)[:, 0], jlog, 1e-4)
    jflat = dict(optim.leaves(jax.tree.map(lambda a: np.asarray(a, np.float32), jcache)))
    for path, leaf in optim.leaves(cache):
        _close(leaf.float(), jflat[path], CACHE_RTOL)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_jax(smoke, remat):
    """The smoke model's loss (cross entropy plus the MoE aux loss), its
    metrics and every gradient leaf against ``jax.value_and_grad(lm.loss_fn)``
    at seq 48 (past ``attn_kv_chunk``: every layer's attention on the flash
    branch)."""
    jcfg, cfg, params = smoke
    jcfg, cfg = jcfg.replace(remat=remat), cfg.replace(remat=remat)
    rng = np.random.default_rng(6)
    B, S = 2, 48
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "loss_mask": (rng.random((B, S)) > 0.1).astype(np.float32)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    tp = from_jax_params(params, device="cpu")
    paths, leaves = zip(*optim.leaves(tp))
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = lm.loss_fn(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert set(metrics) == set(jm) == {"loss", "ce", "aux_loss", "seg1_moe_drop_frac"}
    assert metrics["aux_loss"].item() == pytest.approx(float(jm["aux_loss"]), rel=1e-5)
    jflat = dict(optim.leaves(jax.tree.map(np.asarray, jg)))
    assert set(jflat) == set(paths)
    for path, g in zip(paths, grads):
        _close(g, jflat[path], GRAD_TOL)


def test_gathered_streams_equal_jax(smoke):
    """MegaServe on MLA: ``decode_path="auto"`` takes the gathered path and
    the prefill the dense one on both sides; greedy streams token for token
    against JAX MegaServe (prompts of 7, 21 and 45 tokens: the last one's
    prefill, bucketed past ``attn_kv_chunk``, on the flash branch)."""
    jcfg, cfg, params = smoke
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (7, 21, 45)]
    geom = dict(num_slots=3, block_size=16, num_blocks=24, max_blocks_per_slot=4)
    jsrv = JaxMegaServe(jcfg, jax.tree.map(jnp.asarray, params), JaxServeConfig(**geom))
    srv = MegaServe(cfg, from_jax_params(params, device="cpu"), ServeConfig(**geom),
                    device="cpu")
    assert (srv.decode_path, srv.prefill_path) == ("gathered", "dense")
    assert jsrv.decode_path == "gathered"
    for s in (jsrv, srv):
        for p in prompts:
            s.submit(p, 8, arrival=0.0)
    want, got = jsrv.drain(), srv.drain()
    assert got == want
    assert srv.metrics()["generated_tokens"] == jsrv.metrics()["generated_tokens"] == 24


@pytest.mark.parametrize("how", [dict(decode_path="paged"), dict(spec_decode=True)],
                         ids=["paged", "spec_decode"])
def test_paged_and_speculation_refused_as_jax(smoke, how):
    """The latent cache has no kv-head axis for the paged kernels: the paged
    decode path, and speculation (which needs it), raise on both sides with
    JAX's message; so do the pool-side engine steps."""
    from repro_torch.serve.engine import make_flash_prefill_step, make_paged_decode_step

    jcfg, cfg, params = smoke
    msg = r"decode_path='paged' unsupported \(MLA\)"
    with pytest.raises(ValueError, match=msg):
        JaxMegaServe(jcfg, jax.tree.map(jnp.asarray, params), JaxServeConfig(**how))
    with pytest.raises(ValueError, match=msg):
        MegaServe(cfg, from_jax_params(params, device="cpu"), ServeConfig(**how),
                  device="cpu")
    for make in (make_paged_decode_step, make_flash_prefill_step):
        with pytest.raises(ValueError, match="MLA decodes via the gathered path"):
            make(cfg, block_size=16)


def test_pool_carries_the_latent_leaves(smoke):
    """The paged pool holds MLA's latent leaves without a head axis (``ckv
    [n, NB, bs, 32]``, ``kpe [n, NB, bs, 8]``); ``gather`` views them per
    slot, and ``export_slot``/``import_slot`` move a slot's blocks between
    pools unchanged."""
    from repro_torch.serve.paged_cache import PagedKVCache, PoolSpec

    _, cfg, _ = smoke
    spec = PoolSpec(num_slots=2, num_blocks=6, block_size=16, max_blocks=2)
    src, dst = (PagedKVCache(cfg, spec, torch.device("cpu")) for _ in range(2))
    leaves = dict(optim.leaves(src.pool))
    assert leaves[("seg1", "b0", "ckv")].shape == (2, 6, 16, cfg.mla.kv_lora_rank)
    assert leaves[("seg0", "b0", "kpe")].shape == (1, 6, 16, cfg.mla.qk_rope_head_dim)
    assert all(optim.leaves(src.paged))
    gen = torch.Generator().manual_seed(0)
    for leaf in leaves.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    dense = src.gather(src.pool, torch.tensor([[1, 2], [3, 0]], dtype=torch.int32))
    assert dense["seg1"]["b0"]["ckv"].shape == (2, 2, 32, cfg.mla.kv_lora_rank)
    ckv = src.pool["seg1"]["b0"]["ckv"]
    assert torch.equal(dense["seg1"]["b0"]["ckv"][:, 1, :16], ckv[:, 3])
    bundle = src.export_slot(src.pool, torch.tensor([1, 2]), slot=0)
    dst.import_slot(dst.pool, bundle, torch.tensor([4, 5]), slot=1)
    for name in ("ckv", "kpe"):
        assert torch.equal(dst.pool["seg1"]["b0"][name][:, 4:6],
                           src.pool["seg1"]["b0"][name][:, 1:3])
