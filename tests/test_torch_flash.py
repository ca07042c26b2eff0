"""K2's plain versions against the JAX package on the CPU, in float32: the
forward against ``flash_attention(impl="pallas_interpret")`` with 32-row
blocks, lse against ``layers._flash_forward``, and dq, dk, dv against
``jax.vjp`` of ``layers.attention(impl="chunked")`` (the ``_make_flash``
custom VJP); plus the port's ``attention`` dispatch.

float32 on both sides: the reference walks kv chunks with an online softmax
and the plain version takes whole rows, so they differ by float32 rounding
of O(1) values (TOL).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_bwd_kernel,
    flash_bwd_plain,
    flash_fwd_kernel,
    flash_fwd_plain,
    launches,
)
from repro_torch.models import layers as L  # noqa: E402

TOL = 2e-5
# (B, S, T, H, K, causal, window): ragged S, T (not multiples of 32), G = 2
CASES = [
    (2, 40, 40, 4, 2, True, None),
    (1, 70, 70, 4, 2, True, 16),
    (2, 40, 56, 4, 2, False, None),
    (1, 33, 33, 2, 1, True, None),
]
IDS = ["causal", "window16", "bidirectional-S!=T", "mha"]


def _qkv(B, S, T, H, K, D=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, K, D)).astype(np.float32)
    v = rng.standard_normal((B, T, K, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_matches_pallas_interpret(case):
    B, S, T, H, K, causal, window = case
    q, k, v = _qkv(B, S, T, H, K)
    scale = 0.25
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale=scale, causal=causal, window=window,
                               block_q=32, block_k=32, impl="pallas_interpret"))
    o, lse = flash_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), scale=scale, causal=causal,
                             window=window)
    assert lse.shape == (B * H, S) and lse.dtype == torch.float32
    assert np.abs(o.numpy() - ref).max() <= TOL


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == c[2]],
                         ids=[i for c, i in zip(CASES, IDS) if c[1] == c[2]])
def test_lse_and_grads_match_flash_custom_vjp(case):
    _check_against_custom_vjp(case, D=16)


@pytest.mark.parametrize("case", [(1, 70, 70, 4, 1, True, 16),
                                  (2, 40, 40, 2, 1, True, 24)],
                         ids=["mqa-window16", "mqa-window24"])
def test_head_dim_256_matches_flash_custom_vjp(case):
    """Griffin's attention: head dim 256 (K2 splits its output columns
    across the grid there), MQA, a window shorter than the sequence."""
    _check_against_custom_vjp(case, D=256)


def _check_against_custom_vjp(case, D):
    B, S, T, H, K, causal, window = case
    q, k, v = _qkv(B, S, T, H, K, D=D, seed=1)
    do = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    scale, chunk = D ** -0.5, 16
    G = H // K
    pq = jnp.arange(S)

    qg = jnp.asarray(q).reshape(B, S, K, G, D)
    pad = (-T) % chunk
    kp = jnp.pad(jnp.asarray(k), ((0, 0), (0, pad), (0, 0), (0, 0)))
    vp = jnp.pad(jnp.asarray(v), ((0, 0), (0, pad), (0, 0), (0, 0)))
    _, jlse = JL._flash_forward(qg, kp, vp, pq, jnp.asarray(T, jnp.int32),
                                scale, causal, window, chunk)
    jlse = np.asarray(jlse).reshape(B, S, H).transpose(0, 2, 1).reshape(B * H, S)

    def f(qq, kk, vv):
        return JL.attention(qq, kk, vv, scale=scale, positions_q=pq,
                            causal=causal, window=window, impl="chunked",
                            kv_chunk=chunk)

    jo, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = (np.asarray(a) for a in vjp(jnp.asarray(do)))

    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = flash_fwd_plain(tq, tk, tv, scale=scale, causal=causal, window=window)
    assert np.abs(o.numpy() - np.asarray(jo)).max() <= TOL
    assert np.abs(lse.numpy() - jlse).max() <= TOL
    dq, dk, dv = flash_bwd_plain(tq, tk, tv, o, lse, torch.from_numpy(do),
                                 scale=scale, causal=causal, window=window)
    for ours, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert np.abs(ours.numpy() - ref).max() <= TOL * max(1.0, np.abs(ref).max())

    # the model's attention takes the same path through autograd
    for t in (tq, tk, tv):
        t.requires_grad_(True)
    before = dict(launches)
    out = L.attention(tq, tk, tv, scale=scale, positions_q=torch.arange(S),
                      causal=causal, window=window, impl="chunked", kv_chunk=chunk)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert launches == before  # CPU tensors launch nothing
    for ours, ref in zip(grads, (jdq, jdk, jdv)):
        assert np.abs(ours.numpy() - ref).max() <= TOL * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("impl,seq", [("naive", 40), ("chunked", 16),
                                      ("chunked", 40), ("pallas", 40)])
def test_attention_dispatch_matches_jax(impl, seq):
    """Naive where JAX takes it (``T <= kv_chunk`` or impl naive), K2's
    function on the chunked and Pallas branches."""
    q, k, v = _qkv(1, seq, seq, 4, 2, seed=3)
    kw = dict(scale=0.25, causal=True, window=None, kv_chunk=32)
    jimpl = "pallas_interpret" if impl == "pallas" else impl
    ref = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       positions_q=jnp.arange(seq), impl=jimpl, **kw)
    ours = L.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), positions_q=torch.arange(seq),
                       impl=impl, **kw)
    assert np.abs(ours.numpy() - np.asarray(ref)).max() <= TOL


def test_flash_attention_bf16_rounding_points():
    """On bfloat16 inputs the plain forward rounds p before PV (as
    ``_flash_forward``) and returns bfloat16; the autograd Function's
    backward returns gradients in the inputs' dtypes."""
    q, k, v = (torch.from_numpy(a).bfloat16().requires_grad_(True)
               for a in _qkv(1, 20, 20, 4, 2, seed=4))
    o = flash_attention(q, k, v, scale=0.25)
    assert o.dtype == torch.bfloat16
    gq, gk, gv = torch.autograd.grad(o.float().sum(), (q, k, v))
    assert gq.dtype == gk.dtype == gv.dtype == torch.bfloat16
    assert all(torch.isfinite(g.float()).all() for g in (gq, gk, gv))


@pytest.mark.parametrize("operand", ["q", "k", "v", "o", "do"])
def test_kernel_wrappers_refuse_operands_not_16_byte_aligned(operand):
    """The kernels load every tile by TMA, which reads from 16-byte-aligned
    bases: a contiguous view one element into its storage is refused before
    anything is built or launched (so the check shows on CPU tensors)."""
    B, S, H, K, D = 1, 8, 4, 2, 64
    ops = {n: torch.zeros(shape, dtype=torch.bfloat16) for n, shape in (
        ("q", (B, S, H, D)), ("k", (B, S, K, D)), ("v", (B, S, K, D)),
        ("o", (B, S, H, D)), ("do", (B, S, H, D)))}
    shape = ops[operand].shape
    ops[operand] = torch.zeros(1 + ops[operand].numel(),
                               dtype=torch.bfloat16)[1:].view(shape)
    assert ops[operand].is_contiguous() and ops[operand].data_ptr() % 16
    lse = torch.zeros((B * H, S), dtype=torch.float32)
    with pytest.raises(ValueError, match="aligned"):
        flash_bwd_kernel(ops["q"], ops["k"], ops["v"], ops["o"], lse, ops["do"],
                         scale=0.125)
    if operand in ("q", "k", "v"):
        with pytest.raises(ValueError, match="aligned"):
            flash_fwd_kernel(ops["q"], ops["k"], ops["v"], scale=0.125)
