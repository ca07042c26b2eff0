"""The port's paged-attention kernels: their plain PyTorch versions against the
JAX package on the CPU.  (The CUDA kernels are held against these plain
versions on the card in ``test_torch_gpu.py``.)

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances, float32: 2e-5 between the port's plain decode and JAX's
reference or Pallas kernel (interpret mode), as the JAX package's own tests
hold Pallas to its reference (online softmax vs one-shot softmax, and a
different order of float32 sums); the K/V the prefill writes into the pool
must be bit-equal (same float32 rope, same bfloat16 rounding).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention_pallas,
    paged_attention_ref,
    paged_prefill as jax_paged_prefill,
)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_plain,
    paged_decode_kernel,
    paged_prefill,
    paged_prefill_kernel,
)

F32_TOL = 2e-5

# jitted once per shape: op-by-op dispatch of the banded reference is slow
_jax_decode_ref = jax.jit(paged_attention_ref, static_argnames=("scale", "window"))
_jax_prefill = jax.jit(jax_paged_prefill, static_argnames=(
    "block_size", "scale", "window", "impl", "eps", "rope_theta", "q_start",
    "q_block"))


def _tables(S, M, kv_lens, bs):
    """Distinct physical blocks per slot; padding entries -> null block 0."""
    tbl = np.zeros((S, M), np.int32)
    nxt = 1
    for s in range(S):
        for j in range(min(-(-int(kv_lens[s]) // bs), M)):
            tbl[s, j] = nxt
            nxt += 1
    return tbl


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------------- decode ---


DECODE_CASES = [
    dict(gqa=1, Q=1, kv_lens=[1, 37, 100], window=None, layered=False),
    dict(gqa=2, Q=1, kv_lens=[64, 3, 90], window=None, layered=True),
    dict(gqa=4, Q=1, kv_lens=[17, 128, 50], window=None, layered=False),
    dict(gqa=2, Q=5, kv_lens=[7, 33, 100], window=None, layered=True),
    dict(gqa=4, Q=5, kv_lens=[40, 90, 5], window=None, layered=False),
    dict(gqa=2, Q=1, kv_lens=[70, 120, 16], window=24, layered=False),
    dict(gqa=1, Q=5, kv_lens=[40, 90, 64], window=16, layered=True),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: (
    f"gqa{c['gqa']}-Q{c['Q']}-w{c['window']}-{'5d' if c['layered'] else '4d'}"))
def test_plain_decode_matches_jax(case):
    """paged_attention_plain vs JAX paged_attention_ref and the Pallas
    kernel in interpret mode: GQA 1/2/4, Q=1 and Q=5, ragged kv_len,
    windows, 4-D and 5-D pools."""
    rng = np.random.default_rng(7)
    S, H, dh, bs, M, nb = 3, 4, 16, 16, 8, 30
    K, Q = H // case["gqa"], case["Q"]
    lead = (3,) if case["layered"] else ()
    q = rng.standard_normal((S, Q, H, dh)).astype(np.float32)
    kp = rng.standard_normal(lead + (nb, bs, K, dh)).astype(np.float32)
    vp = rng.standard_normal(lead + (nb, bs, K, dh)).astype(np.float32)
    tbl = _tables(S, M, case["kv_lens"], bs)
    kvl = np.asarray(case["kv_lens"], np.int32)
    layer = 2 if case["layered"] else None
    kw = dict(scale=float(1.0 / np.sqrt(dh)), window=case["window"])
    jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
             jnp.asarray(tbl), jnp.asarray(kvl))
    jlayer = None if layer is None else jnp.asarray(layer, jnp.int32)
    o_ref = np.asarray(_jax_decode_ref(*jargs, layer=jlayer, **kw))
    o_pal = np.asarray(paged_attention_pallas(
        *jargs, layer=jlayer, interpret=True, **kw))
    o = paged_attention_plain(_t(q), _t(kp), _t(vp), _t(tbl), _t(kvl),
                              layer=layer, **kw).numpy()
    np.testing.assert_allclose(o, o_ref, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(o, o_pal, atol=F32_TOL, rtol=0)
    # the CPU dispatch is the plain version itself
    o_ops = paged_attention(_t(q), _t(kp), _t(vp), tables=_t(tbl),
                            kv_len=_t(kvl), layer=layer, **kw).numpy()
    np.testing.assert_array_equal(o_ops, o)


def test_plain_decode_bare_query_layout():
    """A bare ``[S, H, dh]`` query is the Q = 1 case with the axis dropped."""
    rng = np.random.default_rng(3)
    q = _t(rng.standard_normal((2, 4, 16)).astype(np.float32))
    kp = _t(rng.standard_normal((9, 16, 2, 16)).astype(np.float32))
    vp = _t(rng.standard_normal((9, 16, 2, 16)).astype(np.float32))
    tbl = _t(_tables(2, 4, [20, 50], 16))
    kvl = torch.tensor([20, 50], dtype=torch.int32)
    o3 = paged_attention_plain(q, kp, vp, tbl, kvl, scale=0.25)
    o4 = paged_attention_plain(q[:, None], kp, vp, tbl, kvl, scale=0.25)
    np.testing.assert_array_equal(o3.numpy(), o4[:, 0].numpy())


# ------------------------------------------------------------ prefill ---


def _prefill_case(S, Q, H, K, dh, bs, M, kv_lens, *, window=None,
                  qk_norm=False, q_start=None, layered=False, seed=0):
    """Runs the port's paged_prefill (plain path) and JAX's paged_prefill
    under impl="xla" and "pallas_interpret" on the same inputs."""
    rng = np.random.default_rng(seed)
    shape = ((3,) if layered else ()) + (40, bs, K, dh)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    tbl = _tables(S, M, kv_lens, bs)
    kvl = np.asarray(kv_lens, np.int32)
    q = rng.standard_normal((S, Q, H, dh)).astype(np.float32)
    kk = rng.standard_normal((S, Q, K, dh)).astype(np.float32)
    vv = rng.standard_normal((S, Q, K, dh)).astype(np.float32)
    positions = kvl[:, None] - Q + np.arange(Q)[None, :]
    qn = rng.standard_normal(dh).astype(np.float32) if qk_norm else None
    kn = rng.standard_normal(dh).astype(np.float32) if qk_norm else None
    layer = 1 if layered else None
    common = dict(block_size=bs, scale=float(1.0 / np.sqrt(dh)), window=window,
                  rope_theta=10000.0, q_start=q_start, q_block=8)

    jkw = dict(tables=jnp.asarray(tbl), positions=jnp.asarray(positions),
               layer=None if layer is None else jnp.asarray(layer, jnp.int32),
               q_norm=None if qn is None else jnp.asarray(qn),
               k_norm=None if kn is None else jnp.asarray(kn), **common)
    jin = (jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv),
           jnp.asarray(kp), jnp.asarray(vp))
    o_x, c_x = _jax_prefill(*jin, impl="xla", **jkw)
    o_p, _ = _jax_prefill(*jin, impl="pallas_interpret", **jkw)

    tk, tv = _t(kp), _t(vp)  # updated in place by the port
    o = paged_prefill(
        _t(q), _t(kk), _t(vv), tk, tv, tables=_t(tbl),
        positions=_t(positions), layer=layer,
        q_norm=None if qn is None else _t(qn),
        k_norm=None if kn is None else _t(kn), **common,
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(c_x["k"]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(c_x["v"]))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_x), atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_p), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("gqa", [1, 2, 4])
def test_plain_prefill_full_prompt_gqa(gqa):
    """Full prefill (q_start=0) across GQA ratios H/K in {1, 2, 4}."""
    _prefill_case(1, 64, 4, 4 // gqa, 16, 16, 6, [64], q_start=0)


def test_plain_prefill_qk_norm_rope():
    """The q-side qk_norm + rope chain rounds where the kernel prologue does."""
    _prefill_case(1, 64, 8, 2, 16, 16, 6, [64], q_start=0, qk_norm=True)


def test_plain_prefill_chunk_boundary_start():
    """Queries land mid-sequence (48 positions already in the pool)."""
    _prefill_case(1, 32, 4, 2, 16, 16, 8, [32 + 48])


def test_plain_prefill_verify_width_ragged_layered():
    """Q=5 over ragged kv_len (7/33/100) in a layer-stacked pool."""
    _prefill_case(3, 5, 4, 2, 16, 16, 8, [7, 33, 100], layered=True)


@pytest.mark.parametrize("case", [
    dict(S=1, Q=64, H=4, K=2, dh=16, bs=16, M=6, kv_lens=[64], window=24,
         q_start=0),
    dict(S=2, Q=5, H=4, K=2, dh=16, bs=16, M=8, kv_lens=[40, 90], window=16,
         layered=True),
], ids=["full-prompt", "verify-width"])
def test_plain_prefill_window_mask(case):
    """Sliding-window masking inside the causal band."""
    case = dict(case)
    args = [case.pop(k) for k in ("S", "Q", "H", "K", "dh", "bs", "M", "kv_lens")]
    _prefill_case(*args, **case)


def test_plain_prefill_redirects_out_of_reach_writes_to_null_block():
    """Write positions beyond the table's reach land in null block 0 and
    leave every live block alone."""
    rng = np.random.default_rng(5)
    bs, K, dh = 4, 1, 8
    kp = torch.zeros((6, bs, K, dh))
    vp = torch.zeros((6, bs, K, dh))
    tables = torch.tensor([[3, 4]], dtype=torch.int32)        # reach: 8 positions
    positions = torch.arange(6, 11)[None]                     # 8, 9, 10 out of reach
    q = torch.from_numpy(rng.standard_normal((1, 5, 2, dh)).astype(np.float32))
    kk = torch.from_numpy(rng.standard_normal((1, 5, K, dh)).astype(np.float32))
    paged_prefill(q, kk, kk.clone(), kp, vp, tables=tables, positions=positions,
                  block_size=bs, scale=0.3)
    written = {(b, o) for b in range(6) for o in range(bs) if kp[b, o].abs().sum() > 0}
    assert written == {(4, 2), (4, 3), (0, 0), (0, 1), (0, 2)}


# ------------------------------------------- the CUDA wrappers' checks ---


@pytest.mark.parametrize("dh", [8, 48, 256])
def test_kernel_wrappers_refuse_head_dims_they_are_not_built_for(dh):
    """K3 is instantiated for head dims 16, 32, 64, 128 and 256, K4 for the
    first four; any other is refused before anything is built or launched
    (the check runs first, so it shows on CPU tensors too), K4's refusal at
    256 naming its ROADMAP entry.  A head dim K3 takes gets past the check
    to the device check: the CPU tensors are refused there."""
    q = torch.zeros((1, 2, 4, dh), dtype=torch.bfloat16)
    pool = torch.zeros((3, 16, 2, dh), dtype=torch.bfloat16)
    tbl = torch.ones((1, 1), dtype=torch.int32)
    kvl = torch.full((1,), 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="card" if dh == 256 else "head dim"):
        paged_decode_kernel(q, pool, pool, tbl, kvl, scale=0.1)
    with pytest.raises(ValueError, match="head dim 256.*ROADMAP" if dh == 256
                       else "head dim"):
        paged_prefill_kernel(q, pool, pool, tbl, kvl, scale=0.1)


def test_kernel_wrappers_refuse_operands_not_16_byte_aligned():
    """The kernels copy pool rows and queries 16 bytes at a time."""
    q = torch.zeros(1 + 2 * 4 * 64, dtype=torch.bfloat16)[1:].view(1, 2, 4, 64)
    assert q.is_contiguous()
    pool = torch.zeros((3, 16, 2, 64), dtype=torch.bfloat16)
    tbl = torch.ones((1, 1), dtype=torch.int32)
    kvl = torch.full((1,), 2, dtype=torch.int32)
    for kernel in (paged_decode_kernel, paged_prefill_kernel):
        with pytest.raises(ValueError, match="aligned"):
            kernel(q, pool, pool, tbl, kvl, scale=0.1)
