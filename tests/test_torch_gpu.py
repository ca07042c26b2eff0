"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: where there is no card each test skips with its reason
(decided inside the ``cuda`` fixture, so every pytest worker collects the
same tests).  Run them on the card with ``pytest -m gpu tests/test_torch_*.py``.
Imports no JAX: the machine with the card need not have it.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import (
    launches,
    paged_attention_plain,
    paged_decode_kernel,
    paged_prefill_kernel,
    paged_prefill_plain_from_raw,
    reset_launches,
)


def _tables(S, M, kv_lens, bs):
    """Distinct physical blocks per slot; padding entries -> null block 0."""
    tbl = np.zeros((S, M), np.int32)
    nxt = 1
    for s in range(S):
        for j in range(min(-(-int(kv_lens[s]) // bs), M)):
            tbl[s, j] = nxt
            nxt += 1
    return tbl


DECODE_CASES = [
    dict(gqa=1, Q=1, kv_lens=[1, 37, 100], window=None, layered=False),
    dict(gqa=2, Q=1, kv_lens=[64, 3, 90], window=None, layered=True),
    dict(gqa=7, Q=1, kv_lens=[17, 128, 50], window=None, layered=False),
    dict(gqa=2, Q=5, kv_lens=[7, 33, 100], window=None, layered=True),
    dict(gqa=7, Q=5, kv_lens=[40, 90, 5], window=None, layered=False),
    dict(gqa=2, Q=1, kv_lens=[70, 120, 16], window=24, layered=False),
]


# ---------------------------------------------------- card: kernels ---


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from repro_torch.device import resolve_device

    return resolve_device("cuda")


# bfloat16 on the card: the plain version rounds the softmax probabilities to
# bfloat16 before the PV product and the kernel keeps them float32, and both
# round the output to bfloat16 (2^-8 relative); on N(0, 1) values the two
# agree to a few bfloat16 ulps of O(1) outputs
BF16_TOL = 3e-2


def _card_pools(rng, lead, nb, bs, K, dh, dev):
    shape = lead + (nb, bs, K, dh)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dev, torch.bfloat16) for _ in range(2)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: (
    f"gqa{c['gqa']}-Q{c['Q']}-w{c['window']}-{'5d' if c['layered'] else '4d'}"))
def test_decode_kernel_matches_plain(cuda, case):
    rng = np.random.default_rng(11)
    S, dh, bs, M = 3, 64, 16, 8
    H = 14 if case["gqa"] == 7 else 4
    K, Q = H // case["gqa"], case["Q"]
    lead = (3,) if case["layered"] else ()
    kp, vp = _card_pools(rng, lead, 30, bs, K, dh, cuda)
    q = torch.from_numpy(rng.standard_normal((S, Q, H, dh)).astype(np.float32)
                         ).to(cuda, torch.bfloat16)
    tbl = torch.from_numpy(_tables(S, M, case["kv_lens"], bs)).to(cuda)
    kvl = torch.tensor(case["kv_lens"], dtype=torch.int32, device=cuda)
    layer = 2 if case["layered"] else None
    kw = dict(scale=dh ** -0.5, window=case["window"], layer=layer)
    reset_launches()
    o = paged_decode_kernel(q, kp, vp, tbl, kvl, **kw)
    torch.cuda.synchronize()
    assert launches["paged_decode"] == 1
    ref = paged_attention_plain(q, kp, vp, tbl, kvl, **kw)
    assert (o.float() - ref.float()).abs().max().item() < BF16_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("Q,kv_len,window", [(64, 64, None), (40, 90, None),
                                             (64, 64, 24)])
def test_prefill_kernel_matches_plain(cuda, qk_norm, Q, kv_len, window):
    rng = np.random.default_rng(12)
    H, K, dh, bs, M = 14, 2, 64, 16, 8
    kp, vp = _card_pools(rng, (2,), 20, bs, K, dh, cuda)
    q = torch.from_numpy(rng.standard_normal((1, Q, H, dh)).astype(np.float32)
                         ).to(cuda, torch.bfloat16)
    tbl = torch.from_numpy(_tables(1, M, [kv_len], bs)).to(cuda)
    kvl = torch.tensor([kv_len], dtype=torch.int32, device=cuda)
    positions = (kvl.long()[:, None] - Q + torch.arange(Q, device=cuda)[None])
    qn = (torch.from_numpy(rng.standard_normal(dh).astype(np.float32)).to(cuda)
          if qk_norm else None)
    kw = dict(scale=dh ** -0.5, window=window, layer=1, q_norm=qn,
              rope_theta=1e6)
    o = paged_prefill_kernel(q, kp, vp, tbl, kvl, **kw)
    torch.cuda.synchronize()
    ref = paged_prefill_plain_from_raw(q, kp, vp, tbl, kvl,
                                       positions=positions, **kw)
    assert (o.float() - ref.float()).abs().max().item() < BF16_TOL


@pytest.mark.gpu
def test_kernel_wrappers_refuse_wrong_operands(cuda):
    q = torch.zeros((1, 1, 4, 64), device=cuda)          # float32, not bf16
    kp = torch.zeros((4, 16, 2, 64), device=cuda, dtype=torch.bfloat16)
    tbl = torch.zeros((1, 2), device=cuda, dtype=torch.int32)
    kvl = torch.ones((1,), device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError):
        paged_decode_kernel(q, kp, kp, tbl, kvl, scale=0.1)
    with pytest.raises(ValueError):
        paged_decode_kernel(q.bfloat16(), kp, kp, tbl.t(), kvl, scale=0.1)


# ------------------------------------------- card: K1 and K2 (training) ---

# K1 on bfloat16: both round one float32 result per element to bfloat16; the
# kernel's float32 sums add in another order, which can flip a rounding: one
# ulp of that element, at most 2^-7 of the largest |value|.  dscale sums rows
# in float32 in another order before its bfloat16 rounding: 1 % of its
# largest entry.
K1_RTOL = 2.0 ** -7
K1_DSCALE_RTOL = 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("rows,D,sdtype", [(512, 896, torch.bfloat16),
                                          (1001, 128, torch.float32),
                                          (37, 64, torch.bfloat16)])
def test_rmsnorm_kernel_matches_plain(cuda, rows, D, sdtype):
    from repro_torch.kernels.rmsnorm import (
        launches as k1, reset_launches as reset_k1, rmsnorm_bwd_kernel,
        rmsnorm_bwd_plain, rmsnorm_fwd_kernel, rmsnorm_plain)

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((rows, D), generator=g, device=cuda).bfloat16()
    s = (1 + 0.3 * torch.randn((D,), generator=g, device=cuda)).to(sdtype)
    dy = torch.randn((rows, D), generator=g, device=cuda).bfloat16()
    reset_k1()
    y, rstd = rmsnorm_fwd_kernel(x, s, 1e-6)
    dx, ds = rmsnorm_bwd_kernel(x, s, rstd, dy)
    torch.cuda.synchronize()
    assert k1 == {"rmsnorm_fwd": 1, "rmsnorm_bwd": 1}
    ry = rmsnorm_plain(x, s, 1e-6).float()
    assert (y.float() - ry).abs().max() <= K1_RTOL * ry.abs().max()
    rdx, rds = rmsnorm_bwd_plain(x, s, dy, 1e-6)
    rdx = rdx.float()
    assert (dx.float() - rdx).abs().max() <= K1_RTOL * rdx.abs().max()
    assert ds.dtype == sdtype
    assert ((ds.float() - rds.float()).abs().max()
            <= K1_DSCALE_RTOL * rds.float().abs().max())


# K2 on bfloat16, held row by row (one (batch, position, head) vector): both
# sides round each entry to bfloat16 once (an ulp is at most 2^-7 of the
# row's largest entry) and both round p to bfloat16 before PV, but the
# kernel's online max moves between kv tiles, so a few of those roundings
# differ; the limit is four ulps of the row's largest entry.  A limit on the
# whole tensor would not do: late causal rows average many values and are
# small.  lse is float32 on both sides: a few float32 ulps of |lse|.
K2_ROW_RTOL = 2.0 ** -5
K2_LSE_TOL = 1e-5


def _row_err(a, ref):
    """Largest over rows of max |a - ref| / max |ref| (last axis); rows below
    1 % of the median row (sums that cancel to about zero, such as dq of
    query row 0) are divided by that 1 %."""
    d = (a.float() - ref.float()).abs().amax(-1)
    m = ref.float().abs().amax(-1)
    return (d / m.clamp_min(1e-2 * m.median()).clamp_min(1e-30)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,H,K,D,causal,window", [
    (2, 200, 200, 14, 2, 64, True, None),
    (1, 130, 130, 4, 2, 128, True, 50),
    (2, 100, 77, 4, 1, 64, False, None),
    (1, 65, 65, 8, 8, 64, True, None),
    (2, 90, 90, 4, 2, 16, True, None),
    (1, 40, 70, 2, 1, 32, False, 20),
])
def test_flash_kernels_match_plain(cuda, B, S, T, H, K, D, causal, window):
    from repro_torch.kernels.flash_attention import (
        flash_bwd_kernel, flash_bwd_plain, flash_fwd_kernel, flash_fwd_plain)

    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, T, K, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, T, K, D), generator=g, device=cuda).bfloat16()
    do = torch.randn((B, S, H, D), generator=g, device=cuda).bfloat16()
    kw = dict(scale=D ** -0.5, causal=causal, window=window)
    o, lse = flash_fwd_kernel(q, k, v, **kw)
    grads = flash_bwd_kernel(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    ro, rlse = flash_fwd_plain(q, k, v, **kw)
    assert _row_err(o, ro) <= K2_ROW_RTOL
    assert (lse - rlse).abs().max() <= K2_LSE_TOL
    for ours, ref in zip(grads, flash_bwd_plain(q, k, v, o, lse, do, **kw)):
        assert _row_err(ours, ref) <= K2_ROW_RTOL
