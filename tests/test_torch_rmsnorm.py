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


# the backward's plan (csrc/rmsnorm_bwd.cu): every width a training path runs,
# the edge widths, and what an H100's SM gives a CTA (232,448 bytes of shared
# memory a block, of which the kernel's static row-sum buffer takes 128)
WIDTHS = [1, 8, 64, 100, 128, 512, 896, 1024, 2048, 2304, 2560, 3072, 3584, 4096,
          16384]


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("x_f32", [False, True])
def test_backward_plan_covers_each_row_once(D, x_f32):
    from repro_torch.kernels.rmsnorm.ops import _plan

    vec = D % 8 == 0
    G, K, R, stages, smem = _plan(D, x_f32, vec)
    chunks = -(-D // 8)
    # G threads x K chunks reach the row's end and leave no thread a whole
    # round of idle chunks; a warp holds whole groups, a group whole warps
    assert G * K >= chunks and G * (K - 1) < chunks and 1 <= K <= 4
    assert (G <= 32 and 32 % G == 0) or G % 32 == 0
    assert G * R <= 512 and (G * R) % 32 == 0
    assert 1 <= stages <= 3 and (vec or stages == 1)
    # the CTA's [R, K * 8 * G] float32 dscale fold; the staged x, dy and
    # rstd of each stage, and the scale (at most D float32)
    assert smem >= R * G * K * 8 * 4
    per_row = G * (2 * K * 8 * (4 if x_f32 else 2) + 4)
    assert not vec or smem >= stages * R * per_row + 4 * D
    assert smem + 128 <= 232448


@pytest.mark.parametrize("D,G,K", [(896, 32, 4), (2304, 96, 3), (2560, 160, 2),
                                   (3584, 224, 2), (4096, 128, 4), (512, 16, 4),
                                   (128, 4, 4)])
def test_backward_plan_takes_each_width_at_its_exact_size(D, G, K):
    """A width that is a multiple of 8 fills its chunks exactly where a
    K of at most 4 allows it (896 leaves 16 of 128 chunk slots idle)."""
    from repro_torch.kernels.rmsnorm.ops import _plan

    assert _plan(D, False, True)[:2] == (G, K)


def test_backward_on_meta_returns_the_kernels_outputs_and_notes_the_library():
    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_kernel

    before = dict(launches)
    _build.meta_calls.discard("rmsnorm_bwd")
    x = torch.empty((300, 2304), dtype=torch.bfloat16, device="meta")
    s = torch.empty((2304,), dtype=torch.float32, device="meta")
    rstd = torch.empty((300,), dtype=torch.float32, device="meta")
    dx, ds = rmsnorm_bwd_kernel(x, s, rstd, torch.empty_like(x))
    assert dx.is_meta and dx.shape == x.shape and dx.dtype == torch.bfloat16
    assert ds.is_meta and ds.shape == (2304,) and ds.dtype == torch.float32
    assert "rmsnorm_bwd" in _build.meta_calls and launches == before


def test_backward_refuses_what_the_kernel_does_not_take():
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_kernel

    def meta(*shape, dtype=torch.bfloat16, device="meta"):
        return torch.empty(shape, dtype=dtype, device=device)

    x, s, rstd = meta(4, 64), meta(64), meta(4, dtype=torch.float32)
    cpu = meta(4, 64, device="cpu")
    with pytest.raises(ValueError, match="one CUDA device"):
        rmsnorm_bwd_kernel(cpu, meta(64, device="cpu"),
                           meta(4, dtype=torch.float32, device="cpu"), cpu)
    with pytest.raises(ValueError, match="must match x"):
        rmsnorm_bwd_kernel(x, s, rstd, meta(4, 64, dtype=torch.float32))
    with pytest.raises(ValueError, match="rstd must be float32"):
        rmsnorm_bwd_kernel(x, s, meta(4), x)
    with pytest.raises(ValueError, match="does not match D"):
        rmsnorm_bwd_kernel(meta(4, 16385), meta(16385), rstd, meta(4, 16385))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        rmsnorm_bwd_kernel(meta(4, 64, dtype=torch.float16), s, rstd,
                           meta(4, 64, dtype=torch.float16))
