"""K2 with v's head dim ``Dv`` apart from q's and k's ``D`` (MLA), on the CPU:
the plain versions at the smoke config's (24, 16) and deepseek-v2-lite's
(192, 128) against the JAX package in float32 (the forward against
``flash_attention(impl="pallas_interpret")``, lse against
``layers._flash_forward``, dq, dk and dv against ``jax.vjp`` of
``layers.attention(impl="chunked")``, the ``_make_flash`` custom VJP); the
wrappers' refusals of a v, o or dO shaped unlike the pair they take; and
``core.flops.flash_flops``, which counts each product by its own width.

Tolerance: as ``tests/test_torch_flash.py``, float32 rounding of O(1)
values, ``TOL`` (2e-5) absolute on o and lse and relative to the largest
entry of a gradient.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.core import flops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_bwd_kernel,
    flash_bwd_plain,
    flash_fwd_kernel,
    flash_fwd_plain,
)
from repro_torch.kernels.flash_attention.ops import HEAD_DIM_PAIRS  # noqa: E402

TOL = 2e-5
PAIRS = [(24, 16), (192, 128)]
# (B, S, T, H, K, causal, window): ragged lengths, G = 2, a window
CASES = [(2, 40, 40, 4, 2, True, None), (1, 70, 70, 4, 2, True, 16),
         (2, 40, 56, 4, 2, False, None)]
CASE_IDS = ["causal", "window16", "bidirectional-S!=T"]


def _qkv(B, S, T, H, K, D, Dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, T, K, D)).astype(np.float32),
            rng.standard_normal((B, T, K, Dv)).astype(np.float32))


@pytest.mark.parametrize("D,Dv", PAIRS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_forward_matches_pallas_interpret(case, D, Dv):
    B, S, T, H, K, causal, window = case
    q, k, v = _qkv(B, S, T, H, K, D, Dv)
    scale = D ** -0.5
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale=scale, causal=causal, window=window,
                               block_q=32, block_k=32, impl="pallas_interpret"))
    o, lse = flash_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), scale=scale, causal=causal,
                             window=window)
    assert tuple(o.shape) == (B, S, H, Dv) == ref.shape
    assert lse.shape == (B * H, S)
    assert np.abs(o.numpy() - ref).max() <= TOL


@pytest.mark.parametrize("D,Dv", PAIRS)
@pytest.mark.parametrize("case", [c for c in CASES if c[1] == c[2]],
                         ids=[i for c, i in zip(CASES, CASE_IDS) if c[1] == c[2]])
def test_lse_and_grads_match_flash_custom_vjp(case, D, Dv):
    """delta = rowsum(dO * O) over Dv; dq and dk keep D columns, dv Dv."""
    B, S, T, H, K, causal, window = case
    q, k, v = _qkv(B, S, T, H, K, D, Dv, seed=1)
    do = np.random.default_rng(2).standard_normal((B, S, H, Dv)).astype(np.float32)
    scale, chunk, G = D ** -0.5, 16, H // K
    pq = jnp.arange(S)
    qg = jnp.asarray(q).reshape(B, S, K, G, D)
    pad = (-T) % chunk
    kp = jnp.pad(jnp.asarray(k), ((0, 0), (0, pad), (0, 0), (0, 0)))
    vp = jnp.pad(jnp.asarray(v), ((0, 0), (0, pad), (0, 0), (0, 0)))
    _, jlse = JL._flash_forward(qg, kp, vp, pq, jnp.asarray(T, jnp.int32),
                                scale, causal, window, chunk)
    jlse = np.asarray(jlse).reshape(B, S, H).transpose(0, 2, 1).reshape(B * H, S)

    def f(qq, kk, vv):
        return JL.attention(qq, kk, vv, scale=scale, positions_q=pq, causal=causal,
                            window=window, impl="chunked", kv_chunk=chunk)

    jo, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = [np.asarray(a) for a in vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = flash_fwd_plain(tq, tk, tv, scale=scale, causal=causal, window=window)
    assert np.abs(o.numpy() - np.asarray(jo)).max() <= TOL
    assert np.abs(lse.numpy() - jlse).max() <= TOL
    grads = flash_bwd_plain(tq, tk, tv, o, lse, torch.from_numpy(do), scale=scale,
                            causal=causal, window=window)
    for ours, ref in zip(grads, jgrads):
        assert ours.shape == ref.shape
        assert np.abs(ours.numpy() - ref).max() <= TOL * max(1.0, np.abs(ref).max())


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("what", ["v_width", "v_length", "o", "do", "pair"])
def test_wrappers_refuse_misshaped_operands(what):
    """v must be ``[B, T, K, Dv]`` beside k, o and dO ``[B, S, H, Dv]``, and
    (D, Dv) a taken pair; the shapes are checked before the device, so the
    refusals show on CPU tensors."""
    B, S, T, H, K, D, Dv = 1, 8, 8, 4, 2, 192, 128
    ops = dict(q=_bf16(B, S, H, D), k=_bf16(B, T, K, D), v=_bf16(B, T, K, Dv),
               o=_bf16(B, S, H, Dv), do=_bf16(B, S, H, Dv))
    lse = torch.zeros((B * H, S), dtype=torch.float32)
    if what == "v_width":  # v at q's width where the pair is (192, 128)
        ops["v"], match = _bf16(B, T, K, 96), "not taken"
    elif what == "v_length":
        ops["v"], match = _bf16(B, T + 1, K, Dv), "v has shape"
    elif what == "o":
        ops["o"], match = _bf16(B, S, H, D), "o has shape"
    elif what == "do":
        ops["do"], match = _bf16(B, S, H, D), "do has shape"
    else:  # a width pair no instantiation takes
        ops["q"], ops["k"], match = _bf16(B, S, H, 96), _bf16(B, T, K, 96), "not taken"
    assert (192, 128) in HEAD_DIM_PAIRS and (24, 16) in HEAD_DIM_PAIRS
    with pytest.raises(ValueError, match=match):
        flash_bwd_kernel(ops["q"], ops["k"], ops["v"], ops["o"], lse, ops["do"],
                         scale=0.1)
    if what in ("v_width", "v_length", "pair"):
        with pytest.raises(ValueError, match=match):
            flash_fwd_kernel(ops["q"], ops["k"], ops["v"], scale=0.1)
    # on well-shaped CPU operands the wrappers refuse only the device
    good = dict(q=_bf16(B, S, H, D), k=_bf16(B, T, K, D), v=_bf16(B, T, K, Dv))
    with pytest.raises(ValueError, match="runs on the card"):
        flash_fwd_kernel(**good, scale=0.1)


def test_flash_flops_count_each_products_width():
    """2 (D + Dv) flops a query-key pair forward, 2 (3 D + 2 Dv) backward:
    at D = Dv the 4 D and 10 D of before; at (192, 128), B = 2, S = 2048,
    H = 16, causal, the bound's 4.30e10 and 1.117e11."""
    B, S, H = 2, 2048, 16
    pairs = B * H * S * (S + 1) // 2
    kw = dict(causal=True, window=None)
    for D in (64, 128, 256):
        assert flops.flash_flops((B, S, H, D), (B, S, H, D), backward=False, **kw) \
            == 4 * D * pairs
        assert flops.flash_flops((B, S, H, D), (B, S, H, D), backward=True, **kw) \
            == 10 * D * pairs
        assert flops.flash_flops((B, S, H, D), (B, S, H, D), backward=True, dv=D,
                                 **kw) == 10 * D * pairs
    fwd = flops.flash_flops((B, S, H, 192), (B, S, H, 192), backward=False, dv=128, **kw)
    bwd = flops.flash_flops((B, S, H, 192), (B, S, H, 192), backward=True, dv=128, **kw)
    assert fwd == 640 * pairs and bwd == 1664 * pairs
    assert round(fwd / 1e10, 2) == 4.30 and round(bwd / 1e11, 3) == 1.117
    # the autograd Function reports v's width while a step is counted
    q = torch.randn(1, 40, 4, 24, requires_grad=True)
    k = torch.randn(1, 40, 2, 24, requires_grad=True)
    v = torch.randn(1, 40, 2, 16, requires_grad=True)
    from repro_torch.kernels.flash_attention import flash_attention

    n = flops.count_flops(lambda: flash_attention(q, k, v, scale=0.2).sum().backward())
    assert n == flops.flash_flops(q.shape, k.shape, backward=False, dv=16, **kw) \
        + flops.flash_flops(q.shape, k.shape, backward=True, dv=16, **kw)
