"""The chunk algebra of K5's backward (``csrc/wkv6_bwd.cu``) on the CPU.

``wkv6_bwd_chunked_plain`` transcribes the CUDA backward's chunk form in
torch ops: per-chunk state contributions, the two scans over chunks (the
state entering each chunk, the state gradient leaving it), the sub-chunk
sweeps, the decay gradient summed only over the pairs that span each token,
and du summed per chunk in a fixed order.  Held here, on the shapes and
decays the card checks, (1) in float64 to ``wkv6_bwd_plain`` (autograd of
the plain forward), (2) in float32 to ``jax.vjp`` of ``wkv6_ref`` on the
kernel's clamped decay (the oracle ``tests/test_kernels.py`` holds
``wkv6_pallas`` to; ``jax.vjp`` does not go through ``pallas_call``'s grid
in interpret mode), and (3) in float32 to float64 at the card's row limits,
so a form that cancels in float32 fails here before it reaches the card.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.wkv6.ref import wkv6_ref  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6_bwd_plain  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_bwd_chunked_plain  # noqa: E402

NAMES = ("dr", "dk", "dv", "dw", "du")
# the card's row limit for K5's float32 outputs (chip_smoke.py
# WKV_F32_ROW_RTOL); the float32 transcription is held to it on every
# output, dr, dk and dv before their bfloat16 rounding
CARD_ROW_RTOL = 5e-4
# float64 against float64, sums in another order: ~1e-14 of a row measured,
# 2e-9 under w = 1e-4 (dw = dlog d / w there: a row's dlog d is a sum of
# terms up to 1e4 times larger)
F64_ROW_RTOL = 1e-8
# float32 against jax.vjp of the float32 oracle: ~1e-6 of the largest entry
# measured (3e-5 under w = 1e-4, where the float32 cumulative logs of a
# sub-chunk reach -147 and carry 1.5e-5 each)
F32_TOL = 1e-4

# (B, H, T, N, kind): T = 150 ends a 64-token chunk part way through its
# second sub-chunk; 64 is one chunk exactly, 1 a single token
CASES = [
    (2, 2, 150, 16, "model"),
    (1, 2, 64, 64, "model"),
    (1, 2, 1, 16, "model"),
    (1, 2, 100, 16, "brutal"),     # w = 1e-4: -9.2 a token
    (1, 2, 200, 64, "long"),       # w = exp(-exp(-8)) = 0.99966
    (1, 2, 70, 16, "near1"),       # w >= 1 - 1e-7 in places: the clamp holds
]


def _inputs(B, H, T, N, kind, seed):
    """r, k, v bfloat16 values and dy, u, w as float64 numpy arrays, the
    decays as the card draws them (chip_smoke.py _wkv6_inputs)."""
    rng = np.random.default_rng(seed)
    BH = B * H

    def bf16(a):
        return torch.from_numpy(a).bfloat16().double().numpy()

    r, k, v = (bf16(rng.standard_normal((BH, T, N)).astype(np.float32)) for _ in range(3))
    if kind == "brutal":
        w = np.full((BH, T, N), 1e-4)
    elif kind == "long":
        w = np.full((BH, T, N), math.exp(-math.exp(-8.0)))
    else:
        w = np.exp(-np.exp(rng.uniform(-6.0, -1.0, (BH, T, N))))
        if kind == "near1":
            w[:, ::3, ::2] = 1 - 1e-8
            w[:, 1::3, 1::4] = 0.9999999
    w = w.astype(np.float32).astype(np.float64)
    u = (0.5 * rng.standard_normal((H, N))).astype(np.float32).astype(np.float64)
    dy = rng.standard_normal((BH, T, N)).astype(np.float32).astype(np.float64)
    return r, k, v, w, u, dy


def _row_err(a, ref):
    """As the card holds K5: largest over rows of max |a - ref| over the
    row's largest |ref| (rows below 1 % of the median row: that 1 %)."""
    d = (a.double() - ref.double()).abs().amax(-1)
    m = ref.double().abs().amax(-1)
    return (d / m.clamp_min(1e-2 * m.median()).clamp_min(1e-30)).max().item()


def _ids(case):
    B, H, T, N, kind = case
    return f"{kind}-T{T}-N{N}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_chunk_algebra_equals_autograd_in_float64(case):
    """The transcription is the gradient of ``wkv6_plain``, to float64
    rounding, whatever T is against the 64-token chunk."""
    ins = [torch.from_numpy(a) for a in _inputs(*case, seed=1)]
    ours = wkv6_bwd_chunked_plain(*ins)
    ref = wkv6_bwd_plain(*ins)
    for name, g, gr in zip(NAMES, ours, ref):
        assert g.shape == gr.shape, name
        assert _row_err(g, gr) <= F64_ROW_RTOL, name


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_chunk_algebra_matches_jax_vjp_of_the_oracle(case):
    """In float32, against ``jax.vjp`` of ``wkv6_ref`` applied to the
    kernel's clamped decay (du summed over the batch)."""
    B, H, T, N, _ = case
    r, k, v, w, u, dy = (a.astype(np.float32) for a in _inputs(*case, seed=2))

    def clamped_ref(r, k, v, w, u):
        d = jnp.exp(jnp.minimum(jnp.log(jnp.maximum(w, 1e-37)), -1e-6))
        return wkv6_ref(r, k, v, d, u)

    _, vjp = jax.vjp(clamped_ref, *map(jnp.asarray, (r, k, v, w, np.tile(u, (B, 1)))))
    ref = vjp((jnp.asarray(dy), jnp.zeros((B * H, N, N), jnp.float32)))
    ours = wkv6_bwd_chunked_plain(*(torch.from_numpy(a) for a in (r, k, v, w, u, dy)))
    for name, g, gr in zip(NAMES, ours, ref):
        gr = np.asarray(gr)
        if name == "du":
            gr = gr.reshape(B, H, N).sum(0)
        err = np.abs(g.numpy() - gr).max()
        assert err <= F32_TOL * max(np.abs(gr).max(), 1e-6), (name, err)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_chunk_algebra_in_float32_holds_the_card_limits(case):
    """The transcription in float32 against the float64 gradient, row by
    row, within the card's 5e-4: the spanning-pair decay gradient does not
    cancel (FLA's reverse-cumsum identity misses this by 2.3 under
    w = 1e-4).  Held decays get dw = 0."""
    ins = [torch.from_numpy(a) for a in _inputs(*case, seed=3)]
    ref = wkv6_bwd_plain(*ins)
    ours = wkv6_bwd_chunked_plain(*(t.float() for t in ins))
    for name, g, gr in zip(NAMES, ours, ref):
        assert g.dtype == torch.float32, name
        assert _row_err(g, gr) <= CARD_ROW_RTOL, name
    if case[-1] == "near1":
        held = ins[3] >= 1 - 1e-7
        assert (ours[3][held] == 0).all()


def test_dropping_the_cross_chunk_decay_term_misses_the_limit():
    """The pairs from the state entering a sub-chunk to the gradient leaving
    it, a * rowsum(S * G), span every token of the sub-chunk; without them
    dw moves past the card's limit (long memory, where they carry most of
    it)."""
    ins = [torch.from_numpy(a) for a in _inputs(1, 2, 200, 16, "long", seed=4)]
    ref = wkv6_bwd_plain(*ins)
    whole = wkv6_bwd_chunked_plain(*ins)
    dropped = wkv6_bwd_chunked_plain(*ins, drop_cross_dw=True)
    assert _row_err(whole[3], ref[3]) <= F64_ROW_RTOL
    assert _row_err(dropped[3], ref[3]) > 10 * CARD_ROW_RTOL
    for g, gr in zip(dropped[:3] + dropped[4:], ref[:3] + ref[4:]):
        assert _row_err(g, gr) <= F64_ROW_RTOL


@pytest.mark.parametrize("chunk,sub", [(32, 16), (64, 32), (16, 16)])
def test_chunk_algebra_does_not_depend_on_the_chunk_sizes(chunk, sub):
    """The kernels' sizes (64 and 16) are one choice: other chunk and
    sub-chunk sizes give the same gradient."""
    ins = [torch.from_numpy(a) for a in _inputs(1, 2, 90, 16, "model", seed=5)]
    ref = wkv6_bwd_plain(*ins)
    ours = wkv6_bwd_chunked_plain(*ins, chunk=chunk, sub=sub)
    for name, g, gr in zip(NAMES, ours, ref):
        assert _row_err(g, gr) <= F64_ROW_RTOL, name
