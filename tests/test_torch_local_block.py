"""The banded local-block attention (``attn_impl="local_block"``) in the port
against the JAX package on the CPU, in float32.  No config selects it; here
Griffin's smoke config is forced onto it (window 32, MQA: 4 query heads over
1 kv head), at a sequence of 64, two windows and past ``attn_kv_chunk``, so
the dispatch leaves the naive branch for the banded one.

Tolerances as ``tests/test_torch_train.py``'s: float32 sums in another
order.  Outputs within ``TOL`` (1e-5) of the reference's largest entry, the
loss within ``LOSS_RTOL`` (2e-6) relative, gradients within ``GRAD_TOL``
(2e-5) of each leaf's largest entry.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.weights import from_jax_params  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.train_step import grad_tree  # noqa: E402

ARCH = "recurrentgemma-9b"
TOL = 1e-5
LOSS_RTOL = 2e-6
GRAD_TOL = 2e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), err


@pytest.mark.parametrize("K", [1, 2])
def test_local_block_attention_and_grads_match_jax(K):
    """``attention(impl="local_block")`` over 3 windows of 16 (4 query
    heads over ``K`` kv heads): the output and the gradients of q, k and v
    against ``jax.vjp`` of JAX's ``attention``; the first block sees only
    itself, the others their own block and the one before it."""
    rng = np.random.default_rng(K)
    B, S, H, D, W = 2, 48, 4, 16, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, K, D)).astype(np.float32) for _ in range(2))
    dy = rng.standard_normal((B, S, H, D)).astype(np.float32)
    kw = dict(scale=D ** -0.5, window=W, impl="local_block", kv_chunk=8)

    def f(qq, kk, vv):
        return JL.attention(qq, kk, vv, positions_q=jnp.arange(S), **kw)

    want, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(dy))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = L.attention(tq, tk, tv, positions_q=torch.arange(S), **kw)
    _close(got.detach(), want)
    for g, w in zip(torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(dy)), jgrads):
        _close(g, w, GRAD_TOL)


def test_griffin_on_local_block_loss_and_grads_match_jax(monkeypatch):
    """Griffin's smoke model with its local attention on the banded branch
    (taken once a layer forward, and again in its remat recompute): the
    loss and every gradient leaf against ``jax.value_and_grad(
    lm.loss_fn)`` at seq 64 (two windows of 32)."""
    calls = []
    banded = L._local_block_attention
    monkeypatch.setattr(L, "_local_block_attention",
                        lambda *a, **k: calls.append(1) or banded(*a, **k))
    kw = dict(compute_dtype="float32", attn_impl="local_block")
    jcfg = jax_get_config(ARCH, smoke=True).replace(**kw)
    cfg = get_config(ARCH, smoke=True).replace(**kw)
    assert cfg.griffin.window == 32 and cfg.attn_kv_chunk == 32
    params = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    tp = from_jax_params(params, device="cpu")
    for _, leaf in optim.leaves(tp):
        leaf.requires_grad_(True)
    loss, _ = lm.loss_fn(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    grads = dict(optim.leaves(grad_tree(tp, loss)))
    n_attn = sum(kinds.count("attn") * n for kinds, n in lm.segment_layout(cfg))
    assert len(calls) == 2 * n_attn > 0
    jflat = dict(optim.leaves(jax.tree.map(np.asarray, jg)))
    assert set(grads) == set(jflat)
    for path, g in grads.items():
        _close(g, jflat[path], GRAD_TOL)
