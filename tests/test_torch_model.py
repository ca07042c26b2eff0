"""The port's model against the JAX package: the weight conversion, and the
paged serving forward (flash prefill, then paged decode) against JAX
``lm.forward`` with the same ``PagedInfo`` settings, on the same weights,
tokens, block tables and positions.

Weights come from JAX ``lm.init`` with the norm scales and QKV biases
redrawn from numpy (the init leaves them at 1 and 0, which would hide a
wrong cast or a dropped bias).  Tolerances on logits: 1e-4 at float32
compute, where the frameworks differ only in the order of float32 sums.  The
K/V cache is bfloat16 on both sides, so a one-ulp float32 difference in a
projection can flip the bfloat16 rounding of a cached element; the tests
count those flips (a few per run).  A flip on a live position that later
queries weigh heavily moves their logits by up to ~2^-8 |v| (3e-4 was seen
with another prompt seed); on these inputs the flips are harmless and the
1e-4 bound holds.  At bfloat16 compute the bound is BF16_LOGIT_TOL below,
because each framework rounds products and elementwise results to bfloat16
at its own places.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.paged_attention import PagedInfo as JaxPagedInfo  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.paged_cache import PagedKVCache, PoolSpec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.paged_attention import PagedInfo  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.weights import from_jax_params, to_jax_params  # noqa: E402

F32_LOGIT_TOL = 1e-4
# eight bfloat16 ulps of the largest smoke logits (|logit| < 4: ulp 2^-6);
# the measured gap is about three and a half
BF16_LOGIT_TOL = 8 * 2.0 ** -6
# bfloat16 roundings of cached K/V that may differ at float32 compute
MAX_F32_FLIPS = 4

ARCHS = ["qwen2-0.5b", "qwen3-14b"]


def _jax_params(cfg, seed=0):
    params = jax.tree.map(np.asarray, jlm.init(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    blk = params["seg0"]["b0"]
    for tree, names in ((blk["attn"], ("bq", "bk", "bv")),
                        (blk["attn"], ("q_norm", "k_norm")),
                        (blk["ln1"], ("scale",)), (blk["ln2"], ("scale",)),
                        (params["final_norm"], ("scale",))):
        for n in names:
            if n in tree:
                base = 0.0 if n.startswith("b") else 1.0
                tree[n] = (base + 0.3 * rng.standard_normal(tree[n].shape)
                           ).astype(np.float32)
    return params


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_round_trip(arch):
    """from_jax_params / to_jax_params copy every leaf exactly."""
    cfg = jax_get_config(arch, smoke=True)
    ref = jax.tree.map(np.asarray, jlm.init(cfg, jax.random.PRNGKey(3)))
    back = to_jax_params(from_jax_params(ref, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_tree(arch):
    """The port's seeded init builds the JAX tree: same leaves, same shapes,
    float32, and the JAX init's scale rules."""
    cfg = get_config(arch, smoke=True)
    ours = to_jax_params(lm.init(cfg, seed=0, device="cpu"))
    ref = jax.tree.map(np.asarray, jlm.init(jax_get_config(arch, smoke=True),
                                            jax.random.PRNGKey(0)))
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == np.float32
        # same distribution: standard deviations agree to sampling noise
        assert abs(a.std() - b.std()) <= 0.1 * b.std() + 1e-7


def _run_both(arch, compute_dtype, seed=1):
    """Prefill two slots (lengths 27 and 9, right-padded to 32 and 16 as the
    server pads them) through the flash-prefill path, then three paged
    decode steps over both slots; returns the logits of each call, JAX's
    and the port's, and how many pool elements differ at the end."""
    jcfg = jax_get_config(arch, smoke=True).replace(compute_dtype=compute_dtype)
    cfg = get_config(arch, smoke=True).replace(compute_dtype=compute_dtype)
    params = _jax_params(jcfg)
    tp = from_jax_params(params, device="cpu")
    jp = jax.tree.map(jnp.asarray, params)
    bs, nb, S, M = 8, 16, 2, 6
    kv = PagedKVCache(jcfg, PoolSpec(num_slots=S, num_blocks=nb,
                                     block_size=bs, max_blocks=M))
    jpool = kv.pool
    pool = lm.init_pool(cfg, nb, bs, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    lens, padded = [27, 9], [32, 16]
    blocks = [[3, 7, 1, 5], [2, 9]]
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in lens]
    outs_j, outs_t = [], []

    for s in range(S):
        toks = np.zeros((1, padded[s]), np.int32)
        toks[0, :lens[s]] = prompts[s]
        tbl = np.asarray([blocks[s]], np.int32)
        jinfo = JaxPagedInfo(tables=jnp.asarray(tbl), block_size=bs,
                             impl="xla", prefill=True, q_start=0)
        hid, jpool, _ = jlm.forward(
            jcfg, jp, {"tokens": jnp.asarray(toks)}, cache=jpool,
            cache_pos=jnp.zeros((1,), jnp.int32), paged=jinfo,
            paged_flags=kv.paged)
        outs_j.append(np.asarray(JL.logits_fn(jp, jcfg, hid), np.float32))
        info = PagedInfo(tables=torch.from_numpy(tbl), block_size=bs,
                         prefill=True, q_start=0)
        with torch.inference_mode():
            h, _ = lm.forward(cfg, tp, torch.from_numpy(toks).long(), pool=pool,
                           cache_pos=torch.zeros(1, dtype=torch.int32),
                           paged=info)
            outs_t.append(L.logits_fn(tp, cfg, h).float().numpy())

    tables = np.zeros((S, M), np.int32)
    for s in range(S):
        tables[s, :len(blocks[s])] = blocks[s]
    pos = np.asarray(lens, np.int32)
    last = np.asarray([p[-1] for p in prompts], np.int32)
    for _ in range(3):
        jinfo = JaxPagedInfo(tables=jnp.asarray(tables), block_size=bs,
                             impl="xla")
        hid, jpool, _ = jlm.forward(
            jcfg, jp, {"tokens": jnp.asarray(last)[:, None]}, cache=jpool,
            cache_pos=jnp.asarray(pos), paged=jinfo, paged_flags=kv.paged)
        lj = np.asarray(JL.logits_fn(jp, jcfg, hid), np.float32)
        info = PagedInfo(tables=torch.from_numpy(tables), block_size=bs)
        with torch.inference_mode():
            h, _ = lm.forward(cfg, tp, torch.from_numpy(last).long()[:, None],
                           pool=pool, cache_pos=torch.from_numpy(pos),
                           paged=info)
            lt = L.logits_fn(tp, cfg, h).float().numpy()
        outs_j.append(lj)
        outs_t.append(lt)
        last = lj[:, 0, :].argmax(-1).astype(np.int32)  # teacher-force JAX's
        pos = pos + 1
    flips = sum(
        int((np.asarray(jpool["seg0"]["b0"][n], np.float32)
             != pool[n].float().numpy()).sum()) for n in ("k", "v"))
    return outs_j, outs_t, flips


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_fp32(arch):
    outs_j, outs_t, flips = _run_both(arch, "float32")
    for lj, lt in zip(outs_j, outs_t):
        assert lj.shape == lt.shape
        np.testing.assert_allclose(lt, lj, atol=F32_LOGIT_TOL, rtol=0)
    assert flips <= MAX_F32_FLIPS


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_bf16(arch):
    outs_j, outs_t, _ = _run_both(arch, "bfloat16")
    for lj, lt in zip(outs_j, outs_t):
        assert lj.shape == lt.shape
        assert np.isfinite(lt[..., :256]).all()
        np.testing.assert_allclose(lt, lj, atol=BF16_LOGIT_TOL, rtol=0)


def test_padded_vocab_is_masked_and_argmax_takes_the_first_maximum():
    cfg = get_config("qwen2-0.5b", smoke=True).replace(vocab_size=250)
    y = torch.zeros((1, 1, cfg.d_model))
    p = {"embedding": torch.zeros((cfg.padded_vocab, cfg.d_model))}
    logits = L.logits_fn(p, cfg, y)
    assert logits.shape[-1] == 256
    assert (logits[..., 250:] == L.BIG_NEG).all()
    assert int(torch.argmax(logits[0, 0])) == 0  # ties: the first maximum
