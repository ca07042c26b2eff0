"""K5's plain versions against the JAX package on the CPU, in float32.

``wkv6_plain`` (the function the CUDA forward is held to on the card) must
equal the interpret-mode Pallas kernel ``wkv6_pallas`` and the sequential
oracle ``wkv6_ref`` at the shapes of ``tests/test_kernels.py`` plus a ragged
T, brutal decay included; ``wkv6_bwd_plain`` (what the CUDA backward is held
to) must equal ``jax.vjp`` of ``wkv6_ref`` applied to the kernel's clamped
decay.  Inputs come from numpy with a seed and go to both sides.  Float32
on both sides, summed in other orders: outputs agree to ~1e-6 of the
largest entry (TOL below).  The P6 case shows the one known difference to
JAX's default training branch, ``wkv6_chunked``'s log-decay clamp at -2.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.wkv6.kernel import wkv6_pallas  # noqa: E402
from repro.kernels.wkv6.ops import wkv6 as jwkv6  # noqa: E402
from repro.kernels.wkv6.ref import wkv6_ref  # noqa: E402
from repro.models.scan_utils import wkv6_chunked  # noqa: E402
from repro_torch.kernels.wkv6 import (  # noqa: E402
    launches,
    wkv6,
    wkv6_bwd_kernel,
    wkv6_bwd_plain,
    wkv6_fwd_kernel,
    wkv6_plain,
)

# float32, sums over up to T*K terms in another order: max |error| over the
# largest |reference| entry (measured at most ~5e-7 here)
TOL = 1e-5
# brutal decay (w = 1e-4): the chunked forms take exp of differences of
# cumulative logs that reach 32 x 9.2 = 295 within a chunk, where a float32
# ulp is 3e-5, so each pair term carries ~1e-5 relative error (measured
# 1.7e-5 of the largest entry); tests/test_kernels.py holds the Pallas
# kernel to the oracle at 1e-4 there too
TOL_BRUTAL = 1e-4

# (B, H, T, N, Pallas chunk): the shapes of tests/test_kernels.py (B*H = 4
# and 2 rows) and a ragged T that no chunk divides (the Pallas kernel
# asserts T % chunk == 0, so it sits that case out)
CASES = [(2, 2, 64, 16, 16), (1, 2, 96, 32, 32), (2, 3, 50, 16, None)]


def _inputs(B, H, T, N, seed, w=None):
    """r, k, v ~ N(0, 1), w = exp(-exp(U(-4, 0.4))) (moderate decay, as
    tests/test_kernels.py draws it), u ~ N(0, 1) ``[H, N]``; numpy float32."""
    rng = np.random.default_rng(seed)
    BH = B * H
    r, k, v = (rng.standard_normal((BH, T, N)).astype(np.float32) for _ in range(3))
    if w is None:
        w = np.exp(-np.exp(rng.uniform(-4.0, 0.4, (BH, T, N)))).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32)
    return r, k, v, np.broadcast_to(w, (BH, T, N)).astype(np.float32), u


def _close(ours, ref, tol=TOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    err = np.abs(ours - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-6), err


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("brutal", [False, True], ids=["moderate", "brutal"])
@pytest.mark.parametrize("B,H,T,N,chunk", CASES)
def test_plain_forward_matches_pallas_and_ref(B, H, T, N, chunk, brutal):
    r, k, v, w, u = _inputs(B, H, T, N, seed=T + N, w=1e-4 if brutal else None)
    tol = TOL_BRUTAL if brutal else TOL
    y, s = wkv6_plain(*_torch(r, k, v, w, u))
    assert y.dtype == s.dtype == torch.float32
    u_rows = np.tile(u, (B, 1))
    y_ref, s_ref = wkv6_ref(*map(jnp.asarray, (r, k, v, w, u_rows)))
    _close(y, y_ref, tol)
    _close(s, s_ref, tol)
    if chunk is not None:
        y_p, s_p = wkv6_pallas(*map(jnp.asarray, (r, k, v, w, u_rows)),
                               chunk=chunk, interpret=True)
        _close(y, y_p, tol)
        _close(s, s_p, tol)


def test_p6_equals_wkv6_chunked_only_above_its_clamp():
    """P6: ``wkv6_chunked`` (JAX's default training branch) clamps the
    per-step log-decay at -2; K5 is exact.  Where every log w >= -2 they
    agree; with some w < e^-2 the port still equals the exact oracle and
    ``wkv6_chunked`` does not."""
    B, H, T, N = 2, 2, 64, 16
    r, k, v, w, u = _inputs(B, H, T, N, seed=3)
    w = np.maximum(w, math.exp(-2.0) * 1.001).astype(np.float32)
    to_model = lambda a: a.reshape(B, H, T, -1).transpose(0, 2, 1, 3)  # noqa: E731
    y, s = wkv6(*_torch(*(to_model(a) for a in (r, k, v, w))), torch.from_numpy(u))
    y_c, s_c = wkv6_chunked(*map(jnp.asarray, map(to_model, (r, k, v, w))),
                            jnp.asarray(u))
    _close(y, y_c)
    _close(s, s_c)

    w_hard = w.copy()
    w_hard[:, ::5] = 1e-3                  # log w = -6.9 at every fifth token
    y, _ = wkv6(*_torch(*(to_model(a) for a in (r, k, v, w_hard))),
                torch.from_numpy(u))
    y_c, _ = wkv6_chunked(*map(jnp.asarray, map(to_model, (r, k, v, w_hard))),
                          jnp.asarray(u))
    y_ref, _ = jwkv6(*map(jnp.asarray, map(to_model, (r, k, v, w_hard))),
                     jnp.asarray(u), impl="ref")
    _close(y, y_ref)
    gap = np.abs(y.numpy() - np.asarray(y_c)).max() / np.abs(np.asarray(y_ref)).max()
    assert gap > 100 * TOL


def _clamped_ref(r, k, v, w, u):
    """``wkv6_ref`` of the decay the kernels apply: exp of the clamped log."""
    d = jnp.exp(jnp.minimum(jnp.log(jnp.maximum(w, 1e-37)), -1e-6))
    return wkv6_ref(r, k, v, d, u)


@pytest.mark.parametrize("brutal", [False, True], ids=["moderate", "brutal"])
@pytest.mark.parametrize("B,H,T,N,chunk", CASES)
def test_plain_backward_matches_jax_vjp(B, H, T, N, chunk, brutal):
    """Float32 plain gradients against ``jax.vjp`` of the float32 oracle;
    under brutal decay the float64 plain gradients (what the card holds the
    kernel to: the float32 chunked form loses digits there)."""
    r, k, v, w, u = _inputs(B, H, T, N, seed=7 + T, w=1e-4 if brutal else None)
    dy = np.random.default_rng(8).standard_normal(r.shape).astype(np.float32)
    _, vjp = jax.vjp(_clamped_ref, *map(jnp.asarray, (r, k, v, w, np.tile(u, (B, 1)))))
    ref = vjp((jnp.asarray(dy), jnp.zeros((B * H, N, N), jnp.float32)))
    ins = _torch(r, k, v, w, u, dy)
    ours = wkv6_bwd_plain(*(t.double() if brutal else t for t in ins))
    for name, g, gr in zip(("dr", "dk", "dv", "dw", "du"), ours, ref):
        gr = np.asarray(gr)
        if name == "du":
            gr = gr.reshape(B, H, N).sum(0)
        assert g.shape == gr.shape, name
        _close(g, gr)


def test_clamp_stops_the_decay_gradient():
    """Where w >= 1 - 1e-7 the clamp ``min(log w, -1e-6)`` holds, so dw is
    exactly zero there, as torch.clamp's and jnp.minimum's gradients give.
    (The last token's dw is zero too: no later token sees its decay.)"""
    B, H, T, N = 1, 2, 40, 16
    r, k, v, w, u = _inputs(B, H, T, N, seed=11)
    w[:, ::3, ::2] = 1 - 1e-8             # rounds to 1.0 in float32
    w[:, 1::3, 1::4] = 0.9999999           # log w ~ -1.2e-7 > -1e-6
    held = np.zeros(w.shape, bool)
    held[:, ::3, ::2] = held[:, 1::3, 1::4] = held[:, -1] = True
    dy = np.random.default_rng(12).standard_normal(r.shape).astype(np.float32)
    dw = wkv6_bwd_plain(*_torch(r, k, v, w, u, dy))[3].numpy()
    assert (dw[held] == 0).all() and (dw[~held] != 0).all()
    _, vjp = jax.vjp(_clamped_ref, *map(jnp.asarray, (r, k, v, w, np.tile(u, (B, 1)))))
    ref = np.asarray(vjp((jnp.asarray(dy), jnp.zeros((B * H, N, N))))[3])
    assert (ref[held] == 0).all()
    _close(dw, ref)


def test_model_layout_wrapper_matches_jax_ops_and_differentiates():
    """``wkv6`` in the model layout ``[B, T, H, K]`` equals JAX
    ``kernels.wkv6.ops.wkv6(impl="ref")``, and autograd through its layout
    changes gives ``jax.vjp`` of that function."""
    B, H, T, N = 2, 3, 33, 16
    r, k, v, w, u = _inputs(B, H, T, N, seed=21)
    to_model = lambda a: np.ascontiguousarray(  # noqa: E731
        a.reshape(B, H, T, -1).transpose(0, 2, 1, 3))
    ins = [to_model(a) for a in (r, k, v, w)] + [u]
    tins = [t.requires_grad_(True) for t in _torch(*ins)]
    y, s = wkv6(*tins)
    assert y.shape == (B, T, H, N) and s.shape == (B, H, N, N)
    (y_ref, s_ref), vjp = jax.vjp(lambda *a: jwkv6(*a, impl="ref"),
                                  *map(jnp.asarray, ins))
    _close(y, y_ref)
    _close(s, s_ref)
    dy = np.random.default_rng(22).standard_normal(y.shape).astype(np.float32)
    grads = torch.autograd.grad(y, tins, torch.from_numpy(dy))
    ref = vjp((jnp.asarray(dy), jnp.zeros(s.shape, jnp.float32)))
    for g, gr in zip(grads, ref):
        _close(g, gr)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on the card or raise; the CPU path is the
    plain version, chosen by ``wkv6`` from the tensors' device."""
    r, k, v, w, u = _torch(*_inputs(1, 2, 8, 16, seed=0))
    before = dict(launches)
    with pytest.raises(ValueError, match="card"):
        wkv6_fwd_kernel(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u)
    with pytest.raises(ValueError, match="card"):
        wkv6_bwd_kernel(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u, r)
    assert launches == before


def _row_err(a, ref):
    """As the card checks hold K5: largest over rows of max |a - ref| over
    the row's largest |ref| (rows below 1 % of the median row: that 1 %)."""
    d = (a.double() - ref.double()).abs().amax(-1)
    m = ref.double().abs().amax(-1)
    return (d / m.clamp_min(1e-2 * m.median()).clamp_min(1e-30)).max().item()


def test_card_limits_catch_a_dropped_chunk_of_tokens():
    """The card holds K5 row by row to its float64 plain version within 5e-4
    (float32 outputs) and 2^-7 (bfloat16 outputs).  A recurrence that loses
    8 tokens of the state in a long-memory sequence (w = 0.99966, every token
    reaching the last) moves rows of y, the state, dr and dw by 5x the looser
    limit and more."""
    BH, H, T, N = 2, 2, 512, 64
    g = torch.Generator().manual_seed(0)
    r, k, v, dy = (torch.randn((BH, T, N), generator=g, dtype=torch.float64)
                   for _ in range(4))
    w = torch.full((BH, T, N), math.exp(-math.exp(-8.0)), dtype=torch.float64)
    u = torch.randn((H, N), generator=g, dtype=torch.float64)
    k_drop = k.clone()
    k_drop[:, 200:208] = 0.0
    (y, s), (y2, s2) = wkv6_plain(r, k, v, w, u), wkv6_plain(r, k_drop, v, w, u)
    grads = wkv6_bwd_plain(r, k, v, w, u, dy)
    grads2 = wkv6_bwd_plain(r, k_drop, v, w, u, dy)
    moved = [_row_err(y2, y), _row_err(s2, s), _row_err(grads2[0], grads[0]),
             _row_err(grads2[3], grads[3])]
    assert min(moved) > 5 * 2.0 ** -7, moved
