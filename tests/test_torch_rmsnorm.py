"""K1's plain versions against the JAX package on the CPU: the forward
against ``rmsnorm_pallas`` in interpret mode and ``rmsnorm_ref``, and the
backward (dx, dscale) against ``jax.grad`` of ``layers.norm_apply``.

float32: the frameworks differ only in the order of a D-long float32 sum
(ulp-level, TOL_F32).  bfloat16 inputs: both round the float32 result to
bfloat16 once, so a one-ulp float32 difference can flip one rounding: at
most one bfloat16 ulp of the O(1..4) outputs (TOL_BF16).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm.kernel import rmsnorm_pallas  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    launches,
    rmsnorm,
    rmsnorm_bwd_plain,
    rmsnorm_plain,
)
from repro_torch.models import layers as L  # noqa: E402

TOL_F32 = 2e-6
TOL_BF16 = 2.0 ** -5  # one bfloat16 ulp at |y| in [4, 8)
SHAPES = [(16, 64), (13, 96), (2, 5, 128)]  # rows not a multiple of the block


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    s = (1.0 + 0.3 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, s


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas_interpret_and_ref(shape, dtype):
    x, s = _inputs(shape, 0)
    jx = jnp.asarray(x).astype(dtype)
    ref = np.asarray(rmsnorm_pallas(jx, jnp.asarray(s), 1e-6, interpret=True),
                     np.float32)
    np.testing.assert_array_equal(
        ref, np.asarray(rmsnorm_ref(jx, jnp.asarray(s), 1e-6), np.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ours = rmsnorm_plain(tx, torch.from_numpy(s), 1e-6)
    assert ours.dtype == tx.dtype
    tol = TOL_F32 * 8 if dtype == "float32" else TOL_BF16
    assert np.abs(ours.float().numpy() - ref).max() <= tol


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_matches_jax_grad_of_norm_apply(shape):
    x, s = _inputs(shape, 1)
    dy = np.random.default_rng(2).standard_normal(shape).astype(np.float32)

    def f(xx, ss):
        return JL.norm_apply({"scale": ss}, xx, "rmsnorm", 1e-6)

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(s))
    jdx, jds = (np.asarray(a) for a in vjp(jnp.asarray(dy)))
    tx, ts = torch.from_numpy(x), torch.from_numpy(s)
    dx, ds = rmsnorm_bwd_plain(tx, ts, torch.from_numpy(dy), 1e-6)
    assert np.abs(dx.numpy() - jdx).max() <= TOL_F32 * 8 * np.abs(jdx).max()
    assert np.abs(ds.numpy() - jds).max() <= TOL_F32 * 8 * np.abs(jds).max()
    # the model's norm on a CPU tensor is the plain version, and autograd
    # through it gives the same gradient
    tx.requires_grad_(True)
    ts.requires_grad_(True)
    y = L.norm_apply({"scale": ts}, tx, "rmsnorm", 1e-6)
    ax, as_ = torch.autograd.grad(y, (tx, ts), torch.from_numpy(dy))
    assert np.abs(ax.numpy() - jdx).max() <= TOL_F32 * 8 * np.abs(jdx).max()
    assert np.abs(as_.numpy() - jds).max() <= TOL_F32 * 8 * np.abs(jds).max()


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    x, s = _inputs((4, 64), 3)
    before = dict(launches)
    y = rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    assert torch.equal(y, rmsnorm_plain(torch.from_numpy(x), torch.from_numpy(s), 1e-6))
    assert launches == before
