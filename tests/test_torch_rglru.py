"""K6's plain versions against the JAX package on the CPU, in float32.

``rglru_plain`` (the function the CUDA forward is held to on the card) must
equal the sequential oracle ``rglru_ref`` and the two-level associative scan
``scan_utils.lru_scan`` (JAX's default training branch), ragged T and brutal
decay included; ``rglru_bwd_plain`` (what the CUDA backward is held to) must
equal ``jax.vjp`` of ``lru_scan``, the last state's cotangent included.
Against the interpret-mode Pallas kernel ``rglru_pallas`` it is equal where
every log a >= -2 and differs below, where that kernel clips (P7).  Inputs
come from numpy with a seed and go to both sides.  Float32 on both sides,
multiplied in other orders: outputs agree to ~1e-6 of the largest entry
(TOL below).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru.kernel import rglru_pallas  # noqa: E402
from repro.kernels.rglru.ref import rglru_ref  # noqa: E402
from repro.models.scan_utils import lru_scan  # noqa: E402
from repro_torch.kernels.rglru import (  # noqa: E402
    launches,
    rglru_bwd_kernel,
    rglru_bwd_plain,
    rglru_fwd_kernel,
    rglru_plain,
    rglru_scan,
)

# float32, a product chain of up to T terms in another order (the
# associative scan pairs them up): max |error| over the largest |reference|
# entry (measured at most ~4e-7 here)
TOL = 1e-5

# jitted: eager associative scans dispatch thousands of small ops
_lru = jax.jit(lru_scan)
_ref = jax.jit(rglru_ref)


@jax.jit
def _lru_vjp(a, b, dy, dh):
    (y, _), vjp = jax.vjp(lru_scan, a, b)
    return y, vjp((dy, dh))


# (B, T, W, decay): Griffin's decay at init, a ragged T that neither the
# Pallas chunk nor lru_scan's 128-token chunk divides, a T that lru_scan
# walks in 128-token chunks, and brutal decay (log a down to -12)
CASES = [(2, 64, 48, "model"), (1, 77, 33, "model"), (2, 256, 16, "model"),
         (2, 96, 40, "brutal")]
IDS = ["model", "ragged", "chunked", "brutal"]


def _inputs(B, T, W, decay, seed):
    """a, b float32 ``[B, T, W]`` as Griffin makes them: ``log a = -8
    softplus(lam) r`` with lam ~ U(-1, 1) and r = sigmoid(N(0, 1)), ``b =
    sqrt(1 - a^2) x``; ``brutal``: log a ~ U(-12, 0)."""
    rng = np.random.default_rng(seed)
    if decay == "brutal":
        log_a = -rng.uniform(0.0, 12.0, (B, T, W))
    else:
        lam = rng.uniform(-1.0, 1.0, W)
        r = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, W))))
        log_a = -8.0 * np.logaddexp(lam, 0.0) * r
    a = np.exp(log_a).astype(np.float32)
    b = (np.sqrt(-np.expm1(2 * log_a)) * rng.standard_normal((B, T, W))
         ).astype(np.float32)
    return a, b


def _close(ours, ref, tol=TOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-6), err


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("B,T,W,decay", CASES, ids=IDS)
def test_plain_forward_matches_ref_and_lru_scan(B, T, W, decay):
    a, b = _inputs(B, T, W, decay, seed=T + W)
    y, h_last = rglru_plain(*_torch(a, b))
    assert y.dtype == h_last.dtype == torch.float32
    for ref in (_ref(jnp.asarray(a), jnp.asarray(b)),
                _lru(jnp.asarray(a), jnp.asarray(b))):
        _close(y, ref[0])
        _close(h_last, ref[1])


@pytest.mark.parametrize("with_dh_last", [False, True], ids=["dy", "dy+dh_last"])
@pytest.mark.parametrize("B,T,W,decay", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(B, T, W, decay, with_dh_last):
    a, b = _inputs(B, T, W, decay, seed=3 * T + W)
    rng = np.random.default_rng(T)
    dy = rng.standard_normal((B, T, W)).astype(np.float32)
    dh = (rng.standard_normal((B, W)) if with_dh_last else np.zeros((B, W))
          ).astype(np.float32)
    y_ref, (da_ref, db_ref) = _lru_vjp(*map(jnp.asarray, (a, b, dy, dh)))
    ta, tdy, tdh = _torch(a, dy, dh)
    da, db = rglru_bwd_plain(ta, torch.from_numpy(np.array(y_ref)), tdy,
                             tdh if with_dh_last else None)
    _close(da, da_ref)
    _close(db, db_ref)


def test_p7_equals_the_pallas_kernel_only_above_its_clip():
    """P7: ``rglru_pallas`` clips log a to [-2, 0]; K6 is exact.  Where
    every log a >= -2 they agree; with Griffin's decays at init (most
    channels below -2) the port still equals the exact oracle and the
    Pallas kernel does not."""
    B, T, W = 2, 64, 128
    a, b = _inputs(B, T, W, "model", seed=5)
    soft = np.maximum(a, np.exp(-2.0) * 1.001).astype(np.float32)
    y, h_last = rglru_plain(*_torch(soft, b))
    y_p, s_p = rglru_pallas(jnp.asarray(soft), jnp.asarray(b), interpret=True)
    _close(y, y_p)
    _close(h_last, s_p)

    assert (np.log(a) < -2.0).mean() > 0.4
    y, _ = rglru_plain(*_torch(a, b))
    y_p, _ = rglru_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    _close(y, _ref(jnp.asarray(a), jnp.asarray(b))[0])
    gap = np.abs(y.numpy() - np.asarray(y_p)).max() / np.abs(y.numpy()).max()
    assert gap > 100 * TOL


def test_scan_differentiates_through_autograd_and_refuses_a_state():
    """``rglru_scan`` (what the model calls) equals JAX ``lru_scan``, and
    autograd through it gives ``jax.vjp`` of that function, both outputs'
    cotangents included; a carried state belongs to the Griffin serving
    slice; CPU tensors launch nothing."""
    B, T, W = 2, 45, 24
    a, b = _inputs(B, T, W, "model", seed=11)
    ta, tb = (t.requires_grad_(True) for t in _torch(a, b))
    before = dict(launches)
    y, h_last = rglru_scan(ta, tb)
    y_ref, h_ref = _lru(jnp.asarray(a), jnp.asarray(b))
    _close(y, y_ref)
    _close(h_last, h_ref)
    rng = np.random.default_rng(12)
    dy = rng.standard_normal(y.shape).astype(np.float32)
    dh = rng.standard_normal(h_last.shape).astype(np.float32)
    grads = torch.autograd.grad((y, h_last), (ta, tb),
                                (torch.from_numpy(dy), torch.from_numpy(dh)))
    for g, gr in zip(grads, _lru_vjp(*map(jnp.asarray, (a, b, dy, dh)))[1]):
        _close(g, gr)
    assert launches == before
    with pytest.raises(NotImplementedError, match="zero state.*lru_scan"):
        rglru_scan(ta, tb, h0=torch.zeros((B, W)))


def test_kernel_wrappers_refuse_cpu_tensors():
    a, b = _torch(*_inputs(1, 8, 16, "model", seed=0))
    before = dict(launches)
    with pytest.raises(ValueError, match="card"):
        rglru_fwd_kernel(a, b)
    with pytest.raises(ValueError, match="card"):
        rglru_bwd_kernel(a, b, b)
    assert launches == before


def _row_err(x, ref):
    """As the card checks hold K6: largest over rows (one token's W
    channels) of max |x - ref| over the row's largest |ref|."""
    d = (x.double() - ref.double()).abs().amax(-1)
    m = ref.double().abs().amax(-1)
    return (d / m.clamp_min(1e-2 * m.median()).clamp_min(1e-30)).max().item()


def test_card_limits_catch_a_dropped_token():
    """The card holds K6 row by row to its float64 plain version (limits in
    ``chip_smoke.py``, 1e-6).  A recurrence that drops one token's
    input moves the rows after it by far more: y and da by over 1e-2
    of a row's largest entry at Griffin's decays."""
    B, T, W = 2, 256, 64
    a, b = (t.double() for t in _torch(*_inputs(B, T, W, "model", seed=21)))
    dy = torch.from_numpy(np.random.default_rng(22).standard_normal((B, T, W)))
    b_drop = b.clone()
    b_drop[:, 100] = 0.0
    (y, _), (y2, _) = rglru_plain(a, b), rglru_plain(a, b_drop)
    grads, grads2 = rglru_bwd_plain(a, y, dy), rglru_bwd_plain(a, y2, dy)
    moved = [_row_err(y2, y), _row_err(grads2[0], grads[0])]
    assert min(moved) > 1e-2, moved
