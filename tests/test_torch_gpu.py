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


def _row_err(a, ref):
    """Largest over rows of max |a - ref| / max |ref| (last axis); rows below
    1 % of the median row (sums that cancel to about zero, such as dq of
    query row 0) are divided by that 1 %."""
    d = (a.float() - ref.float()).abs().amax(-1)
    m = ref.float().abs().amax(-1)
    return (d / m.clamp_min(1e-2 * m.median()).clamp_min(1e-30)).max().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from repro_torch.device import resolve_device

    return resolve_device("cuda")


# K3 and K4 on bfloat16, held row by row as K2 is (one (slot, query, head)
# output vector, relative to the row's largest entry; _row_err above): a
# row of a long kv_len averages many values and is small, so a limit on the
# whole tensor would miss a dropped split or kv tile.  Both sides round each
# entry to bfloat16 once; the plain version rounds the normalised
# probabilities to bfloat16 before PV, K3 keeps them float32 and K4 rounds
# the unnormalised ones; the limit is four ulps of the row's largest entry.
PAGED_ROW_RTOL = 2.0 ** -5


def _card_pools(rng, lead, nb, bs, K, dh, dev):
    shape = lead + (nb, bs, K, dh)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dev, torch.bfloat16) for _ in range(2)]


def _card_queries(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev, torch.bfloat16)


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
    q = _card_queries(rng, (S, Q, H, dh), cuda)
    tbl = torch.from_numpy(_tables(S, M, case["kv_lens"], bs)).to(cuda)
    kvl = torch.tensor(case["kv_lens"], dtype=torch.int32, device=cuda)
    layer = 2 if case["layered"] else None
    kw = dict(scale=dh ** -0.5, window=case["window"], layer=layer)
    reset_launches()
    o = paged_decode_kernel(q, kp, vp, tbl, kvl, **kw)
    torch.cuda.synchronize()
    assert launches["paged_decode"] == 1
    ref = paged_attention_plain(q, kp, vp, tbl, kvl, **kw)
    assert _row_err(o, ref) <= PAGED_ROW_RTOL


# the decode kernel splits the table walk every 128 positions: kv_len at a
# split edge and one past it, 1, a window across an edge (and one starting
# on it), Q = 5 across edges, a table width M not a multiple of the split,
# qwen3-14b's heads at dh 128, the smoke width, another block size
@pytest.mark.gpu
@pytest.mark.parametrize("H,K,dh,bs,M,Q,kv_lens,window", [
    (14, 2, 64, 16, 17, 1, [128, 129, 256, 257, 1], None),
    (14, 2, 64, 16, 23, 1, [300, 260, 356], 100),
    (14, 2, 64, 16, 17, 5, [130, 260, 5], None),
    (14, 2, 64, 16, 132, 1, [2112, 544, 160, 140], None),
    (40, 8, 128, 16, 44, 5, [129, 700], None),
    (4, 2, 16, 16, 20, 1, [1, 200, 300], None),
    (8, 2, 32, 8, 40, 2, [127, 129, 300], 64),
    # the served heads of minitron-4b (G = 3), minicpm-2b (MHA) and
    # phi3.5-moe (G = 4)
    (24, 8, 128, 16, 132, 1, [2112, 544, 160, 140], None),
    (36, 36, 64, 16, 17, 5, [130, 260, 5], None),
    (32, 8, 128, 16, 17, 1, [128, 129, 256, 257, 1], None),
])
def test_decode_kernel_across_split_edges(cuda, H, K, dh, bs, M, Q, kv_lens, window):
    rng = np.random.default_rng(13)
    S = len(kv_lens)
    kp, vp = _card_pools(rng, (), 1 + M * S, bs, K, dh, cuda)
    q = _card_queries(rng, (S, Q, H, dh), cuda)
    tbl = torch.from_numpy(_tables(S, M, kv_lens, bs)).to(cuda)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    kw = dict(scale=dh ** -0.5, window=window)
    o = paged_decode_kernel(q, kp, vp, tbl, kvl, **kw)
    torch.cuda.synchronize()
    ref = paged_attention_plain(q, kp, vp, tbl, kvl, **kw)
    assert _row_err(o, ref) <= PAGED_ROW_RTOL


def _prefill_case(cuda, rng, *, S, Q, H, K, dh, bs, M, kv_lens, window, qk_norm,
                  layered):
    lead = (2,) if layered else ()
    kp, vp = _card_pools(rng, lead, 1 + M * S, bs, K, dh, cuda)
    q = _card_queries(rng, (S, Q, H, dh), cuda)
    tbl = torch.from_numpy(_tables(S, M, kv_lens, bs)).to(cuda)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    positions = (kvl.long()[:, None] - Q + torch.arange(Q, device=cuda)[None])
    qn = (torch.from_numpy(rng.standard_normal(dh).astype(np.float32)).to(cuda)
          if qk_norm else None)
    kw = dict(scale=dh ** -0.5, window=window, layer=1 if layered else None,
              q_norm=qn, rope_theta=1e6)
    reset_launches()
    o = paged_prefill_kernel(q, kp, vp, tbl, kvl, **kw)
    torch.cuda.synchronize()
    assert launches["paged_prefill"] == 1
    ref = paged_prefill_plain_from_raw(q, kp, vp, tbl, kvl, positions=positions,
                                       **kw)
    return _row_err(o, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("Q,kv_len,window", [(64, 64, None), (40, 90, None),
                                             (64, 64, 24)])
def test_prefill_kernel_matches_plain(cuda, qk_norm, Q, kv_len, window):
    rng = np.random.default_rng(12)
    err = _prefill_case(cuda, rng, S=1, Q=Q, H=14, K=2, dh=64, bs=16, M=8,
                        kv_lens=[kv_len], window=window, qk_norm=qk_norm,
                        layered=True)
    assert err <= PAGED_ROW_RTOL


# the prefill kernel walks 64-position kv tiles for 64-query tiles: P not a
# multiple of 64, a mid-sequence chunk under a window, qwen3-14b's heads at
# dh 128 with qk_norm, the smoke width with slots at different kv_len,
# another block size
@pytest.mark.gpu
@pytest.mark.parametrize("S,Q,H,K,dh,bs,kv_lens,window,qk_norm", [
    (1, 100, 14, 2, 64, 16, [100], None, False),
    (1, 65, 14, 2, 64, 16, [1000], 300, False),
    (1, 300, 40, 8, 128, 16, [300], None, True),
    (2, 77, 4, 2, 16, 16, [77, 200], None, False),
    (2, 130, 8, 2, 32, 8, [130, 131], 70, True),
    # minitron-4b's, minicpm-2b's and phi3.5-moe's heads
    (1, 300, 24, 8, 128, 16, [300], None, False),
    (2, 100, 36, 36, 64, 16, [100, 1000], None, False),
    (1, 130, 32, 8, 128, 16, [130], None, False),
])
def test_prefill_kernel_across_tile_edges(cuda, S, Q, H, K, dh, bs, kv_lens, window,
                                          qk_norm):
    rng = np.random.default_rng(14)
    M = max(-(-k // bs) for k in kv_lens)
    err = _prefill_case(cuda, rng, S=S, Q=Q, H=H, K=K, dh=dh, bs=bs, M=M,
                        kv_lens=kv_lens, window=window, qk_norm=qk_norm,
                        layered=False)
    assert err <= PAGED_ROW_RTOL


# K4 at the shapes the served chunked prefill and speculative verify give
# it: Q = spec_k + 1 = 5 over 8 ragged slots (one slot's last rows past its
# table's reach: kv_len 2115 over 132 blocks of 16), and chunks of 32 and
# 256 queries over a cached prefix at block-aligned starts
@pytest.mark.gpu
@pytest.mark.parametrize("S,Q,kv_lens,M,layered", [
    (8, 5, [2115, 544, 160, 2080, 530, 140, 2100, 600], 132, True),
    (8, 5, [5, 21, 144, 1029, 16, 6, 77, 2112], 132, False),
    (1, 32, [32], 2, True),
    (1, 32, [2048], 128, False),
    (1, 256, [1024], 64, True),
    (1, 256, [2048], 128, False),
], ids=["verify-pad-rows", "verify-ragged", "chunk32-first", "chunk32-last",
        "chunk256-mid", "chunk256-last"])
def test_prefill_kernel_at_served_shapes(cuda, S, Q, kv_lens, M, layered):
    rng = np.random.default_rng(15)
    err = _prefill_case(cuda, rng, S=S, Q=Q, H=14, K=2, dh=64, bs=16, M=M,
                        kv_lens=kv_lens, window=None, qk_norm=False,
                        layered=layered)
    assert err <= PAGED_ROW_RTOL


@pytest.mark.gpu
def test_kernel_wrappers_refuse_wrong_operands(cuda):
    q = torch.zeros((1, 1, 4, 64), device=cuda, dtype=torch.float16)  # not bf16 or f32
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


def _k1_case(cuda, rows, D, xdtype, sdtype, seed=0, offset=0):
    """x, scale and dy; ``offset`` elements into a larger buffer moves x and
    dy off 16-byte alignment (the backward's scalar path)."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rows_of(t):
        buf = torch.empty(rows * D + offset, dtype=xdtype, device=cuda)
        buf[offset:] = t.reshape(-1).to(xdtype)
        return buf[offset:].view(rows, D)

    x = rows_of(torch.randn((rows, D), generator=g, device=cuda))
    s = (1 + 0.3 * torch.randn((D,), generator=g, device=cuda)).to(sdtype)
    dy = rows_of(torch.randn((rows, D), generator=g, device=cuda))
    return x, s, dy


# every width a training path runs (the backward is CUDA C++ since its
# redesign: 512, 896, 2048, 2304, 2560, 3072, 3584, 4096) and the edges of
# its plan: one row, fewer rows than CTAs, a width that is not a multiple of
# 8 (scalar loads), rows off 16-byte alignment, the widest D, float32 x and
# float32 scale
@pytest.mark.gpu
@pytest.mark.parametrize("rows,D,xdtype,sdtype,offset", [
    (512, 896, torch.bfloat16, torch.bfloat16, 0),
    (1001, 128, torch.bfloat16, torch.float32, 0),
    (37, 64, torch.bfloat16, torch.bfloat16, 0),
    (8192, 2560, torch.bfloat16, torch.bfloat16, 0),
    (8192, 2304, torch.bfloat16, torch.bfloat16, 0),
    (1000, 3072, torch.bfloat16, torch.bfloat16, 0),
    (513, 3584, torch.bfloat16, torch.bfloat16, 0),
    (4096, 512, torch.bfloat16, torch.bfloat16, 0),
    (16384, 896, torch.bfloat16, torch.bfloat16, 0),
    (8192, 2048, torch.bfloat16, torch.bfloat16, 0),
    (8192, 3072, torch.bfloat16, torch.bfloat16, 0),
    (8192, 3584, torch.bfloat16, torch.bfloat16, 0),
    (8192, 4096, torch.bfloat16, torch.bfloat16, 0),
    (1, 896, torch.bfloat16, torch.bfloat16, 0),
    (7, 2304, torch.bfloat16, torch.float32, 0),
    (300, 100, torch.bfloat16, torch.bfloat16, 0),
    (333, 896, torch.bfloat16, torch.bfloat16, 1),
    (64, 16384, torch.bfloat16, torch.bfloat16, 0),
    (1000, 896, torch.float32, torch.bfloat16, 0),
    (513, 3584, torch.float32, torch.float32, 0),
    (100, 16384, torch.float32, torch.float32, 0),
    (2048, 512, torch.bfloat16, torch.float32, 0),
])
def test_rmsnorm_kernel_matches_plain(cuda, rows, D, xdtype, sdtype, offset):
    from repro_torch.kernels.rmsnorm import (
        launches as k1, reset_launches as reset_k1, rmsnorm_bwd_kernel,
        rmsnorm_bwd_plain, rmsnorm_fwd_kernel, rmsnorm_plain)

    x, s, dy = _k1_case(cuda, rows, D, xdtype, sdtype, offset=offset)
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
    assert dx.dtype == xdtype and ds.dtype == sdtype
    assert ((ds.float() - rds.float()).abs().max()
            <= K1_DSCALE_RTOL * rds.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("rows,D", [(4096, 512), (8192, 2304), (37, 100)])
def test_rmsnorm_bwd_is_bit_identical_again_and_in_a_graph_replay(cuda, rows, D):
    """No float atomics, and the grid barrier's counters are left at zero:
    a second launch and the replays of a captured one give the same bits."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_kernel, rmsnorm_fwd_kernel

    x, s, dy = _k1_case(cuda, rows, D, torch.bfloat16, torch.bfloat16, seed=3)
    _, rstd = rmsnorm_fwd_kernel(x, s, 1e-6)
    first = rmsnorm_bwd_kernel(x, s, rstd, dy)
    again = rmsnorm_bwd_kernel(x, s, rstd, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rmsnorm_bwd_kernel(x, s, rstd, dy)   # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        captured = rmsnorm_bwd_kernel(x, s, rstd, dy)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, captured))
    assert all(torch.equal(a, b) for a, b in zip(first, rmsnorm_bwd_kernel(x, s, rstd, dy)))


@pytest.mark.gpu
def test_rmsnorm_bwd_is_one_launch(cuda):
    """dx and dscale come out of one kernel: no reduction or cast after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_kernel, rmsnorm_fwd_kernel

    x, s, dy = _k1_case(cuda, 4096, 512, torch.bfloat16, torch.bfloat16)
    _, rstd = rmsnorm_fwd_kernel(x, s, 1e-6)
    rmsnorm_bwd_kernel(x, s, rstd, dy)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rmsnorm_bwd_kernel(x, s, rstd, dy)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "rmsnorm_bwd_kernel" in names[0], names


# K2 on bfloat16, held row by row (one (batch, position, head) vector): both
# sides round each entry to bfloat16 once (an ulp is at most 2^-7 of the
# row's largest entry) and both round p to bfloat16 before PV, but the
# kernel's online max moves between kv tiles, so a few of those roundings
# differ; the limit is four ulps of the row's largest entry.  A limit on the
# whole tensor would not do: late causal rows average many values and are
# small.  lse is float32 on both sides: a few float32 ulps of |lse|.
K2_ROW_RTOL = 2.0 ** -5
K2_LSE_TOL = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,H,K,D,causal,window", [
    (2, 200, 200, 14, 2, 64, True, None),
    (1, 130, 130, 4, 2, 128, True, 50),
    (2, 100, 77, 4, 1, 64, False, None),
    (1, 65, 65, 8, 8, 64, True, None),
    (2, 90, 90, 4, 2, 16, True, None),
    (1, 40, 70, 2, 1, 32, False, 20),
    # one past and one short of the tiles: 128 query rows a forward and dq
    # block, 128 keys a forward kv tile and dk/dv block, 64-row steps
    (1, 129, 127, 14, 2, 64, True, None),
    (1, 127, 129, 14, 2, 64, False, None),
    (2, 257, 257, 14, 2, 64, True, None),
    (1, 63, 65, 4, 1, 128, True, None),
    (1, 193, 191, 4, 2, 32, False, 50),
    # a window narrower than a tile, and one that ends mid-tile
    (1, 300, 300, 14, 2, 64, True, 40),
    (1, 300, 300, 4, 2, 128, True, 100),
    # G = 7 (qwen2's 14 query heads over 2 kv heads) at dh 128
    (1, 150, 150, 7, 1, 128, True, None),
    # dh 16 and 32 (one zero-padded 64-column chunk) across tile edges
    (1, 129, 129, 4, 2, 16, True, 20),
    (1, 257, 200, 4, 1, 32, True, None),
    # bidirectional window: rows past T + window see no key (l = 0); a
    # minority, so the median row that _row_err scales by is not zero
    (1, 100, 60, 2, 1, 64, False, 10),
    # qwen2-vl-7b's heads (G = 7 at dh 128), minicpm-2b's (MHA at dh 64),
    # phi3.5-moe's (G = 4 at dh 128)
    (1, 300, 300, 28, 4, 128, True, None),
    (2, 257, 257, 36, 36, 64, True, None),
    (1, 200, 200, 32, 8, 128, True, None),
    # seamless-m4t's heads (MHA, 16 of 64), bidirectional: the encoder's
    # self-attention (S = T), the cross-attention over a longer memory
    # (S apart from T), and its tile edges
    (1, 512, 512, 16, 16, 64, False, None),
    (1, 300, 750, 16, 16, 64, False, None),
    (1, 129, 2047, 16, 16, 64, False, None),
    # a tensor rank's heads at tp 2: recurrentgemma-9b's (H 8, one kv head,
    # dh 256, window 2048) at its world cell's 2048 x 2, phi3.5-moe's (G 4)
    (2, 2048, 2048, 8, 1, 256, True, 2048),
    (1, 300, 300, 16, 4, 128, True, None),
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


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv", [(192, 128), (24, 16)], ids=["mla", "mla-smoke"])
@pytest.mark.parametrize("B,S,T,H,K,causal,window", [
    (2, 300, 300, 16, 16, True, None),
    # one past and one short of the tiles (128-query blocks, 128-key forward
    # tiles, 64-key dk/dv blocks at (192, 128), 64-row steps)
    (1, 129, 127, 16, 16, True, None),
    (1, 257, 257, 4, 2, True, 40),
    (1, 100, 60, 2, 1, False, 10),
])
def test_flash_kernels_match_plain_with_v_head_dim_apart(cuda, D, Dv, B, S, T, H, K,
                                                         causal, window):
    """K2 with v's head dim apart from q's (MLA's 192 / 128, its smoke
    config's 24 / 16): o and lse, dq, dk and dv against the plain versions,
    row by row at K2's limits; the backward bit-identical on a second run."""
    from repro_torch.kernels.flash_attention import (
        flash_bwd_kernel, flash_bwd_plain, flash_fwd_kernel, flash_fwd_plain)

    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, T, K, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, T, K, Dv), generator=g, device=cuda).bfloat16()
    do = torch.randn((B, S, H, Dv), generator=g, device=cuda).bfloat16()
    kw = dict(scale=D ** -0.5, causal=causal, window=window)
    o, lse = flash_fwd_kernel(q, k, v, **kw)
    assert o.shape == (B, S, H, Dv)
    grads = flash_bwd_kernel(q, k, v, o, lse, do, **kw)
    again = flash_bwd_kernel(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    ro, rlse = flash_fwd_plain(q, k, v, **kw)
    assert _row_err(o, ro) <= K2_ROW_RTOL
    assert (lse - rlse).abs().max() <= K2_LSE_TOL
    for ours, ref in zip(grads, flash_bwd_plain(q, k, v, o, lse, do, **kw)):
        assert ours.shape == ref.shape
        assert _row_err(ours, ref) <= K2_ROW_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("D,window", [(64, None), (256, 100)])
def test_flash_backward_is_the_same_from_run_to_run(cuda, D, window):
    """No float atomics: dq, dk and dv are bit-identical on a second run."""
    from repro_torch.kernels.flash_attention import flash_bwd_kernel, flash_fwd_kernel

    B, S, H, K = 2, 300, 8, 2
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, S, K, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, S, K, D), generator=g, device=cuda).bfloat16()
    do = torch.randn((B, S, H, D), generator=g, device=cuda).bfloat16()
    kw = dict(scale=D ** -0.5, causal=True, window=window)
    o, lse = flash_fwd_kernel(q, k, v, **kw)
    first = flash_bwd_kernel(q, k, v, o, lse, do, **kw)
    second = flash_bwd_kernel(q, k, v, o, lse, do, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# ------------------------------------------------ card: K5 (WKV6) ---

# K5 against its plain version evaluated in float64 on the same inputs,
# held row by row (one token's, state row's or head's N entries, relative to
# the row's largest entry).  y, the state, dw and du are float32 sums in
# another order (chip_smoke.py measured at most 7.1e-5 on the H100, dw
# under brutal decay); dr, dk and dv are rounded to bfloat16 once (half an
# ulp: 2^-8 of the row's largest entry).  Limits: 7x the float32
# measurement, one bfloat16 ulp.
K5_F32_ROW_RTOL = 5e-4
K5_BF16_ROW_RTOL = 2.0 ** -7


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,N,kind", [
    (4, 2048, 40, 64, "model"),     # the rwkv6-3b training shape
    (2, 100, 40, 64, "model"),      # ragged T
    (1, 300, 8, 64, "brutal"),      # w = 1e-4
    (1, 2048, 4, 64, "long"),       # w = exp(-exp(-8)) = 0.99966
    (2, 90, 4, 64, "near1"),        # w >= 1 - 1e-7: the clamp holds
    (1, 77, 3, 16, "model"),        # the smoke configs' head size
    (2, 2048, 20, 64, "model"),     # a tp 2 rank's heads of rwkv6-3b
])
def test_wkv6_kernels_match_plain(cuda, B, T, H, N, kind):
    import math

    from repro_torch.kernels.wkv6 import (
        launches as k5, reset_launches as reset_k5, wkv6_bwd_kernel,
        wkv6_bwd_plain, wkv6_fwd_kernel, wkv6_plain)

    g = torch.Generator(device=cuda).manual_seed(3)
    BH = B * H
    r, k, v = (torch.randn((BH, T, N), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    if kind == "brutal":
        w = torch.full((BH, T, N), 1e-4, device=cuda)
    elif kind == "long":
        w = torch.full((BH, T, N), math.exp(-math.exp(-8.0)), device=cuda)
    else:
        w = torch.exp(-torch.exp(-6 + 5 * torch.rand((BH, T, N), generator=g,
                                                      device=cuda)))
        if kind == "near1":
            w[:, ::3, ::2] = 1 - 1e-8
            w[:, 1::3, 1::4] = 0.9999999
    u = 0.5 * torch.randn((H, N), generator=g, device=cuda)
    dy = torch.randn((BH, T, N), generator=g, device=cuda)
    reset_k5()
    y, s = wkv6_fwd_kernel(r, k, v, w, u)
    grads = wkv6_bwd_kernel(r, k, v, w, u, dy)
    torch.cuda.synchronize()
    assert k5 == {"wkv6_fwd": 1, "wkv6_bwd": 1}
    f64 = [t.double() for t in (r, k, v, w, u, dy)]
    ry, rs = wkv6_plain(*f64[:5])
    assert _row_err(y, ry) <= K5_F32_ROW_RTOL
    assert _row_err(s, rs) <= K5_F32_ROW_RTOL
    refs = wkv6_bwd_plain(*f64)
    for name, ours, ref in zip(("dr", "dk", "dv", "dw", "du"), grads, refs):
        assert ours.shape == ref.shape, name
        lim = K5_BF16_ROW_RTOL if name in ("dr", "dk", "dv") else K5_F32_ROW_RTOL
        assert _row_err(ours, ref) <= lim, name
    if kind == "near1":
        held = w >= 1 - 1e-7
        assert (grads[3][held] == 0).all()


@pytest.mark.gpu
def test_wkv6_wrappers_refuse_wrong_operands(cuda):
    from repro_torch.kernels.wkv6 import wkv6_fwd_kernel

    r = torch.zeros((4, 8, 64), device=cuda)              # float32, not bf16
    w = torch.zeros((4, 8, 64), device=cuda)
    u = torch.zeros((2, 64), device=cuda)
    with pytest.raises(TypeError):
        wkv6_fwd_kernel(r, r, r, w, u)
    rb = r.bfloat16()
    with pytest.raises(ValueError, match="head size"):
        wkv6_fwd_kernel(rb[..., :32].contiguous(), rb[..., :32].contiguous(),
                        rb[..., :32].contiguous(), w[..., :32].contiguous(),
                        u[:, :32].contiguous())
    with pytest.raises(ValueError, match="heads"):
        wkv6_fwd_kernel(rb, rb, rb, w, torch.zeros((3, 64), device=cuda))


def _wkv6_rows(g, dev, BH, T, N, H):
    """r, k, v bf16, model decays w, u, dy as ``[B*H, T, N]`` rows."""
    r, k, v = (torch.randn((BH, T, N), generator=g, device=dev).bfloat16()
               for _ in range(3))
    w = torch.exp(-torch.exp(-6 + 5 * torch.rand((BH, T, N), generator=g, device=dev)))
    u = 0.5 * torch.randn((H, N), generator=g, device=dev)
    dy = torch.randn((BH, T, N), generator=g, device=dev)
    return r, k, v, w, u, dy


@pytest.mark.gpu
@pytest.mark.parametrize("N", [16, 64])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 129])
def test_wkv6_kernels_at_chunk_edges(cuda, T, N):
    """The kernels cut a row into chunks of 64 tokens (four sub-chunks of
    16): one token, a chunk less one, one chunk, one more, two and one,
    held to the plain version in float64 at the card's row limits."""
    from repro_torch.kernels.wkv6 import (
        wkv6_bwd_kernel, wkv6_bwd_plain, wkv6_fwd_kernel, wkv6_plain)

    g = torch.Generator(device=cuda).manual_seed(T + N)
    H = 4
    r, k, v, w, u, dy = _wkv6_rows(g, cuda, 2 * H, T, N, H)
    y, s = wkv6_fwd_kernel(r, k, v, w, u)
    grads = wkv6_bwd_kernel(r, k, v, w, u, dy)
    torch.cuda.synchronize()
    f64 = [t.double() for t in (r, k, v, w, u, dy)]
    ry, rs = wkv6_plain(*f64[:5])
    assert _row_err(y, ry) <= K5_F32_ROW_RTOL
    assert _row_err(s, rs) <= K5_F32_ROW_RTOL
    for name, ours, ref in zip(("dr", "dk", "dv", "dw", "du"), grads,
                               wkv6_bwd_plain(*f64)):
        lim = K5_BF16_ROW_RTOL if name in ("dr", "dk", "dv") else K5_F32_ROW_RTOL
        assert _row_err(ours, ref) <= lim, name


@pytest.mark.gpu
def test_wkv6_model_layout_is_bit_equal_to_rows(cuda):
    """The kernels read the model's [B, T, H, N] in place, and dy in a layout
    of its own: y, the state and every gradient are bit-equal to the call
    on contiguous [B*H, T, N] rows."""
    from repro_torch.kernels.wkv6 import wkv6_bwd_kernel, wkv6_fwd_kernel

    B, T, H, N = 2, 200, 4, 64
    g = torch.Generator(device=cuda).manual_seed(11)
    rows = _wkv6_rows(g, cuda, B * H, T, N, H)
    r, k, v, w, u, dy = rows

    def to_model(t):
        return t.view(B, H, T, N).permute(0, 2, 1, 3).contiguous()

    model = [to_model(t) for t in (r, k, v, w)]
    dy_view = dy.view(B, H, T, N).permute(0, 2, 1, 3)   # strided, not contiguous
    y1, s1 = wkv6_fwd_kernel(r, k, v, w, u)
    y2, s2 = wkv6_fwd_kernel(*model, u)
    assert y2.shape == (B, T, H, N) and s2.shape == (B, H, N, N)
    assert torch.equal(to_model(y1), y2) and torch.equal(s1.view(B, H, N, N), s2)
    g1 = wkv6_bwd_kernel(r, k, v, w, u, dy)
    g2 = wkv6_bwd_kernel(*model, u, dy_view)
    for a, b in zip(g1[:4], g2[:4]):
        assert torch.equal(to_model(a), b)
    assert torch.equal(g1[4], g2[4])


@pytest.mark.gpu
def test_wkv6_backward_is_the_same_from_run_to_run(cuda):
    """No float atomics: every gradient, du included, is bit-identical on a
    second run."""
    from repro_torch.kernels.wkv6 import wkv6_bwd_kernel

    g = torch.Generator(device=cuda).manual_seed(12)
    r, k, v, w, u, dy = _wkv6_rows(g, cuda, 8, 300, 64, 4)
    first = wkv6_bwd_kernel(r, k, v, w, u, dy)
    second = wkv6_bwd_kernel(r, k, v, w, u, dy)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_wkv6_kernels_take_more_rows_than_a_grid_dimension_y(cuda):
    """The chunk kernels put every (row, chunk) block on gridDim.x: 65,540
    rows (more than gridDim.y's 65,535) of two chunks, held to the plain
    version in float64 (evaluated 8,192 rows at a time; du summed over the
    groups)."""
    from repro_torch.kernels.wkv6 import (
        wkv6_bwd_kernel, wkv6_bwd_plain, wkv6_fwd_kernel, wkv6_plain)

    BH, H, G = 65540, 4, 8192
    g = torch.Generator(device=cuda).manual_seed(14)
    r, k, v, w, u, dy = _wkv6_rows(g, cuda, BH, 70, 16, H)
    y, s = wkv6_fwd_kernel(r, k, v, w, u)
    *grads, du = wkv6_bwd_kernel(r, k, v, w, u, dy)
    torch.cuda.synchronize()
    ref_du = torch.zeros((H, 16), dtype=torch.float64, device=cuda)
    for i in range(0, BH, G):
        rows = slice(i, i + G)
        f64 = [t[rows].double() for t in (r, k, v, w)]
        ry, rs = wkv6_plain(*f64, u.double())
        assert _row_err(y[rows], ry) <= K5_F32_ROW_RTOL
        assert _row_err(s[rows], rs) <= K5_F32_ROW_RTOL
        *refs, part = wkv6_bwd_plain(*f64, u.double(), dy[rows].double())
        for name, ours, ref in zip(("dr", "dk", "dv", "dw"), grads, refs):
            lim = K5_BF16_ROW_RTOL if name != "dw" else K5_F32_ROW_RTOL
            assert _row_err(ours[rows], ref) <= lim, (name, i)
        ref_du += part
    assert _row_err(du, ref_du) <= K5_F32_ROW_RTOL


@pytest.mark.gpu
def test_wkv6_model_path_makes_no_layout_copies(cuda):
    """``wkv6`` in the model layout, forward and backward through autograd,
    launches K5's kernels and no copy kernel (the [B*H, T, N] transposes of
    PRs 13-16 are gone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.wkv6 import wkv6

    B, T, H, N = 2, 130, 4, 64
    g = torch.Generator(device=cuda).manual_seed(13)
    r, k, v, w, u, dy = _wkv6_rows(g, cuda, B * H, T, N, H)
    ins = [t.view(B, H, T, N).permute(0, 2, 1, 3).contiguous().requires_grad_(True)
           for t in (r, k, v, w)] + [u.requires_grad_(True)]
    dy = dy.view(B, H, T, N).permute(0, 2, 1, 3).contiguous()
    y, _ = wkv6(*ins)
    torch.autograd.grad(y, ins, dy)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        y, _ = wkv6(*ins)
        torch.autograd.grad(y, ins, dy)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert any("wkv6_fwd_out" in n for n in names), names
    assert any("wkv6_bwd_grad" in n for n in names), names
    assert not [n for n in names if "copy" in n.lower()], names


# ------------------------------------------------ card: K6 (RG-LRU) ---

# K6 against its plain version evaluated in float64 on the same inputs, held
# row by row (one token's W channels, relative to the row's largest entry):
# y, h_last, da and db are float32 FMA chains whose rounding decays with a;
# the limit is chip_smoke.py's RGLRU_ROW_RTOL.
K6_ROW_RTOL = 1e-6


def _rglru_card_inputs(g, dev, B, T, W, kind):
    if kind == "brutal":
        log_a = -12 * torch.rand((B, T, W), generator=g, device=dev)
    elif kind == "long":   # log a in [-1e-2, -1e-4]: the carries dominate
        log_a = -(1e-4 + (1e-2 - 1e-4) * torch.rand((B, T, W), generator=g, device=dev))
    else:
        lam = 2 * torch.rand((W,), generator=g, device=dev) - 1
        log_a = -8 * torch.logaddexp(lam, torch.zeros_like(lam)) * torch.sigmoid(
            torch.randn((B, T, W), generator=g, device=dev))
    b = torch.sqrt(-torch.expm1(2 * log_a)) * torch.randn((B, T, W), generator=g,
                                                           device=dev)
    return torch.exp(log_a), b


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,W,kind,with_dh", [
    (2, 4096, 4096, "model", False),   # the Griffin training shape
    (1, 1000, 1000, "model", True),    # ragged T and W, the last state's cotangent
    (1, 512, 4096, "brutal", True),    # log a down to -12
    (3, 5, 130, "model", True),        # fewer tokens than the loads ahead
    (2, 1003, 130, "model", True),     # T mid-piece and mid-window (15 x 64 + 43)
    (1, 4096, 64, "model", True),      # 2 blocks for 132 SMs
    (1, 1, 33, "model", True),         # one token: the top window is the first
    (1, 2048, 512, "long", True),      # long memory: the carries dominate
    (2, 2048, 2048, "model", False),   # a tp 2 rank's channels of recurrentgemma-9b
])
def test_rglru_kernels_match_plain(cuda, B, T, W, kind, with_dh):
    from repro_torch.kernels.rglru import (
        launches as k6, reset_launches as reset_k6, rglru_bwd_kernel,
        rglru_bwd_plain, rglru_fwd_kernel, rglru_plain)

    g = torch.Generator(device=cuda).manual_seed(4)
    a, b = _rglru_card_inputs(g, cuda, B, T, W, kind)
    dy = torch.randn((B, T, W), generator=g, device=cuda)
    dh = torch.randn((B, W), generator=g, device=cuda) if with_dh else None
    reset_k6()
    y, h_last = rglru_fwd_kernel(a, b)
    da, db = rglru_bwd_kernel(a, y, dy, dh)
    torch.cuda.synchronize()
    assert k6 == {"rglru_fwd": 1, "rglru_bwd": 1}
    ry, rh = rglru_plain(a.double(), b.double())
    assert _row_err(y, ry) <= K6_ROW_RTOL
    assert _row_err(h_last, rh) <= K6_ROW_RTOL
    rda, rdb = rglru_bwd_plain(a.double(), ry, dy.double(),
                               None if dh is None else dh.double())
    assert _row_err(da, rda) <= K6_ROW_RTOL
    assert _row_err(db, rdb) <= K6_ROW_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,W", [(2, 4096, 4096), (2, 1003, 130)])
def test_rglru_kernels_are_deterministic(cuda, B, T, W):
    """A fixed order and no atomics: a second run gives the same bits."""
    from repro_torch.kernels.rglru import rglru_bwd_kernel, rglru_fwd_kernel

    g = torch.Generator(device=cuda).manual_seed(8)
    a, b = _rglru_card_inputs(g, cuda, B, T, W, "model")
    dy = torch.randn((B, T, W), generator=g, device=cuda)
    dh = torch.randn((B, W), generator=g, device=cuda)
    runs = []
    for _ in range(2):
        y, h_last = rglru_fwd_kernel(a, b)
        runs.append((y, h_last, *rglru_bwd_kernel(a, y, dy, dh)))
    torch.cuda.synchronize()
    first, again = runs
    for x, x2 in zip(first, again):
        assert torch.equal(x, x2)


@pytest.mark.gpu
def test_rglru_wrappers_refuse_wrong_operands(cuda):
    from repro_torch.kernels.rglru import rglru_fwd_kernel

    a = torch.zeros((2, 8, 64), device=cuda)
    with pytest.raises(TypeError):
        rglru_fwd_kernel(a.bfloat16(), a)
    with pytest.raises(ValueError, match="contiguous"):
        rglru_fwd_kernel(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        rglru_fwd_kernel(a, a[:, :4].contiguous())


# ------------------------------- card: K3 at Griffin's head dim 256 ---


# recurrentgemma-9b's attention (16 query heads over one kv head of 256,
# window 2048): ragged kv_len around the window, the window's first live
# position kv_len - 2048 across K3's split edges (127, 128, 129, 256), and no
# window; bfloat16 queries and a float32 model's; each run twice for the
# same bits
@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("M,kv_lens,window,layered", [
    (256, [1, 2047, 2048, 2049, 3000, 4096, 129, 2176], 2048, True),
    (200, [2175, 2176, 2177, 2304, 2047], 2048, False),
    (192, [1, 300, 2100, 3064], None, True),
])
def test_decode_kernel_at_head_dim_256_matches_plain(cuda, M, kv_lens, window, layered,
                                                     q_dtype):
    rng = np.random.default_rng(17)
    S, H, K, dh, bs = len(kv_lens), 16, 1, 256, 16
    lead = (2,) if layered else ()
    kp, vp = _card_pools(rng, lead, 1 + M * S, bs, K, dh, cuda)
    q = _card_queries(rng, (S, 1, H, dh), cuda).to(q_dtype)
    tbl = torch.from_numpy(_tables(S, M, kv_lens, bs)).to(cuda)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    kw = dict(scale=dh ** -0.5, window=window, layer=1 if layered else None)
    o = paged_decode_kernel(q, kp, vp, tbl, kvl, **kw)
    again = paged_decode_kernel(q, kp, vp, tbl, kvl, **kw)
    torch.cuda.synchronize()
    ref = paged_attention_plain(q, kp, vp, tbl, kvl, **kw)
    assert o.dtype == q_dtype
    assert _row_err(o, ref) <= PAGED_ROW_RTOL
    assert torch.equal(o, again)


@pytest.mark.gpu
def test_decode_kernel_refuses_shared_memory_past_the_device_limit(cuda):
    """Q = 5 at head dim 256 (a verify step of 16 query heads over one kv
    head) needs 258,368 bytes of shared memory a split block, past the 227
    KB a block may opt into: refused before any launch."""
    from repro_torch.kernels.paged_attention.ops import (
        shared_memory_bytes, shared_memory_limit)

    assert shared_memory_bytes("paged_decode", H=16, K=1, dh=256, Q=5) > \
        shared_memory_limit(cuda) >= shared_memory_bytes("paged_decode", H=16, K=1, dh=256)
    rng = np.random.default_rng(0)
    kp, vp = _card_pools(rng, (), 9, 16, 1, 256, cuda)
    q = _card_queries(rng, (1, 5, 16, 256), cuda)
    tbl = torch.arange(1, 9, dtype=torch.int32, device=cuda)[None]
    kvl = torch.tensor([100], dtype=torch.int32, device=cuda)
    reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        paged_decode_kernel(q, kp, vp, tbl, kvl, scale=0.0625)
    assert launches["paged_decode"] == 0


# ------------------------- card: the recurrent families' served streams ---


def _plain_replay(cfg, params, prompt, forced, dev, bs=16):
    """Teacher-forced logits of ``forced`` after ``prompt`` through the
    plain versions, as MegaServe runs a recurrent family: the prompt's pow2
    segments over a dense cache, scattered into a pool, then paged decode."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import make_paged_decode_step, make_seg_prefill
    from repro_torch.serve.paged_cache import (
        PagedKVCache, PoolSpec, blocks_for, pow2_bucket, pow2_segments)

    n_blk = blocks_for(len(prompt) + len(forced), bs)
    bucket = min(pow2_bucket(blocks_for(len(prompt), bs)), n_blk)
    kv = PagedKVCache(cfg, PoolSpec(num_slots=1, num_blocks=n_blk + 1, block_size=bs,
                                    max_blocks=n_blk), dev)
    cache = lm.init_cache(cfg, 1, bucket * bs, device=dev)
    seg = make_seg_prefill(cfg, plain=True)
    toks, off = torch.tensor([prompt], device=dev), 0
    for w in pow2_segments(len(prompt)):
        logits, _ = seg(params, cache, toks[:, off:off + w], off)
        off += w
    table = torch.arange(1, n_blk + 1, dtype=torch.int32, device=dev)[None]
    kv.scatter_prefill(kv.pool, cache, 0, table[0, :bucket])
    decode = make_paged_decode_step(cfg, block_size=bs, plain=True)
    out = [logits]
    for i, tok in enumerate(forced[:-1]):
        pos = torch.tensor([len(prompt) + i], dtype=torch.int32, device=dev)
        out.append(decode(params, kv.pool, table, torch.tensor([tok], device=dev),
                          pos)[0][0])
    return torch.stack(out).float()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_served_recurrent_smoke_stream_follows_the_plain_replay(cuda, arch):
    """MegaServe on the card (bf16 smoke config, kernels) serves prompts of
    45 and 13 tokens (a clamped 32-wide segment, then exact ones) for 40
    steps, Griffin's decode past its window of 32; wherever the plain
    replay's top two logits lie more than ``LOGIT_TOL`` (chip_smoke.py's
    0.25) apart, the served token is the plain replay's choice."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import MegaServe, ServeConfig

    logit_tol = 0.25
    cfg = get_config(arch, smoke=True)
    srv = MegaServe(cfg, lm.init(cfg, seed=0, device=cuda), ServeConfig(
        num_slots=2, block_size=16, num_blocks=17, max_blocks_per_slot=8), device=cuda)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (45, 13)]
    rids = [srv.submit(p, 40) for p in prompts]
    streams = srv.drain()
    checked = 0
    for rid, prompt in zip(rids, prompts):
        lp = _plain_replay(cfg, srv.params, prompt, streams[rid], cuda)[:, :cfg.vocab_size]
        top2 = lp.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > logit_tol
        served = torch.tensor(streams[rid], device=cuda)
        assert torch.equal(served[clear], lp.argmax(-1)[clear])
        checked += int(clear.sum())
    assert checked > 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["chunked", "spec"])
def test_served_chunked_and_spec_launch_k4_per_chunk_and_verify(cuda, mode):
    """MegaServe on the card (bf16 qwen2 smoke config): chunked prefill
    launches K4 once a layer a chunk or short prompt, speculation once a
    layer a prompt and a verify step; K3 once a layer a decode tick; every
    request finishes with valid tokens and speculation accepts drafts of a
    repetitive prompt."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import MegaServe, ServeConfig

    cfg = get_config("qwen2-0.5b", smoke=True)
    extra = (dict(chunked_prefill=True) if mode == "chunked"
             else dict(spec_decode=True, spec_k=4))
    srv = MegaServe(cfg, lm.init(cfg, seed=0, device=cuda), ServeConfig(
        num_slots=3, block_size=16, num_blocks=40, max_blocks_per_slot=12,
        **extra), device=cuda)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (100, 20, 64)]
    prompts.append([5, 6, 7, 8] * 20)
    for p in prompts:
        srv.submit(p, 24)
    reset_launches()
    streams = srv.drain()
    names = [e.name for e in srv.trace_events()]
    L = cfg.num_layers
    n_k4 = names.count("prefill") + names.count("prefill_chunk") + names.count("verify")
    assert launches["paged_prefill"] == L * n_k4 > 0
    assert launches["paged_decode"] == L * names.count("decode")
    assert all(len(s) == 24 and all(0 <= t < cfg.vocab_size for t in s)
               for s in streams.values())
    if mode == "chunked":
        assert names.count("prefill_chunk") == 4 + 2 + 3  # 100, 64, 80 by 32
    else:
        assert srv.metrics()["spec_accepted"] > 0


# --------------------------------- card: K2 at Griffin's head dim 256 ---


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,window", [
    (1, 700, 16, 256),     # MQA (G = 16), window < S
    (2, 130, 4, 2048),     # window > S: plain causal
    (1, 333, 8, 100),      # ragged S, several window tiles
    (1, 65, 4, 2048),      # S one past a 64-key tile and a 64-query step
    (1, 127, 4, 40),       # window narrower than a tile; S one short of 128
    (1, 257, 16, 100),     # G = 16, S one past 256, window ends mid-tile
])
def test_flash_kernels_at_head_dim_256_match_plain(cuda, B, S, H, window):
    from repro_torch.kernels.flash_attention import (
        flash_bwd_kernel, flash_bwd_plain, flash_fwd_kernel, flash_fwd_plain)

    D = 256
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, S, 1, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, S, 1, D), generator=g, device=cuda).bfloat16()
    do = torch.randn((B, S, H, D), generator=g, device=cuda).bfloat16()
    kw = dict(scale=D ** -0.5, causal=True, window=window)
    o, lse = flash_fwd_kernel(q, k, v, **kw)
    grads = flash_bwd_kernel(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    ro, rlse = flash_fwd_plain(q, k, v, **kw)
    assert _row_err(o, ro) <= K2_ROW_RTOL
    assert (lse - rlse).abs().max() <= K2_LSE_TOL
    for ours, ref in zip(grads, flash_bwd_plain(q, k, v, o, lse, do, **kw)):
        assert _row_err(ours, ref) <= K2_ROW_RTOL


# ------------------------------------ card: one Griffin smoke train step ---


@pytest.mark.gpu
def test_griffin_smoke_train_step_launches_its_kernels(cuda):
    """One train step of the recurrentgemma-9b smoke config on the card goes
    through K6 (3 rec layers), K2 (1 windowed attention layer) and K1, as
    often as full remat says, and gives a finite loss near the plain
    path's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, rglru, rmsnorm
    from repro_torch.train.optim import OptimizerConfig
    from repro_torch.train.train_step import (
        copy_state, init_train_state, make_train_step)

    cfg = get_config("recurrentgemma-9b", smoke=True)
    state = init_train_state(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
             for k in ("tokens", "targets")}
    ocfg = OptimizerConfig(warmup_steps=1, total_steps=2)
    for m in (flash_attention, rglru, rmsnorm):
        m.reset_launches()
    _, plain = make_train_step(cfg, ocfg, plain=True)(copy_state(state), batch)
    _, ours = make_train_step(cfg, ocfg)(state, batch)
    torch.cuda.synchronize()
    assert rglru.launches == {"rglru_fwd": 6, "rglru_bwd": 3}
    assert flash_attention.launches == {"flash_fwd": 2, "flash_bwd": 1}
    assert rmsnorm.launches == {"rmsnorm_fwd": 17, "rmsnorm_bwd": 9}
    assert np.isfinite(ours["loss"].item())
    assert abs(ours["loss"].item() - plain["loss"].item()) <= 1e-2


# ------------------------------- card: the runtime (Session, checkpoints) ---


@pytest.mark.gpu
def test_session_trains_on_the_card_with_trace_and_metrics(cuda, tmp_path):
    """Two qwen2 smoke steps through the CLI's Session on the card: the
    chrome trace holds ``init`` and both steps, the metrics file a row per
    step with the device-memory gauge, and the flop count gives an MFU
    estimate in (0, 1)."""
    import json

    from repro_torch.app import cli
    from repro_torch.core.tracing import load_trace

    out = cli.run(["train", "--arch", "qwen2-0.5b", "--smoke", "--steps", "2",
                   "--set", "train.seq_len=64", "--modules", "scan,metrics",
                   "--trace-out", str(tmp_path / "t.json"),
                   "--metrics-out", str(tmp_path / "m.jsonl"),
                   "--set", "obs.peak_tflops=989"])
    names = [e.name for e in load_trace(tmp_path / "t.json") if e.kind != "counter"]
    assert sorted(names) == ["init", "train_step", "train_step"]
    rows = [json.loads(ln) for ln in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["train.loss"] for r in rows] == [h["loss"] for h in out["history"]]
    assert all(r["train.device_mem_bytes"] > 0 for r in rows)
    assert 0 < out["session"].results["metrics"]["mfu_est"] < 1


@pytest.mark.gpu
def test_checkpoint_round_trip_of_card_leaves(cuda, tmp_path):
    from repro_torch.checkpoint import restore, save

    gen = torch.Generator(device=cuda).manual_seed(0)
    state = {"w": torch.randn(64, 96, generator=gen, device=cuda).to(torch.bfloat16),
             "m": torch.randn(7, 5, generator=gen, device=cuda),
             "step": 11}
    save(state, 11, tmp_path)
    target = {"w": torch.zeros(64, 96, dtype=torch.bfloat16, device=cuda),
              "m": torch.zeros(7, 5, device=cuda), "step": 0}
    back, _ = restore(tmp_path, target)
    assert back["step"] == 11
    for k in ("w", "m"):
        assert back[k].device == state[k].device and back[k].dtype == state[k].dtype
        assert torch.equal(back[k], state[k])


@pytest.mark.gpu
def test_save_async_snapshot_survives_an_in_place_step(cuda, tmp_path):
    """``save_async`` copies the state off the card before it returns, so a
    train step right after (AdamW updates master and moments in place) does
    not reach the checkpoint."""
    from repro_torch.checkpoint import Checkpointer, restore
    from repro_torch.configs import get_config
    from repro_torch.train.optim import OptimizerConfig, leaves
    from repro_torch.train.train_step import (
        copy_state, init_train_state, make_train_step)

    cfg = get_config("qwen2-0.5b", smoke=True)
    state = init_train_state(cfg, seed=0, device=cuda)
    saved = copy_state(state)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
             for k in ("tokens", "targets")}
    ck = Checkpointer(tmp_path)
    ck.save_async(state, 1)
    state, _ = make_train_step(cfg, OptimizerConfig(warmup_steps=1))(state, batch)
    ck.wait()
    back, _ = restore(tmp_path, state)
    for (path, a), (_, b) in zip(leaves(back.master), leaves(saved.master)):
        assert torch.equal(a, b), path
    assert back.opt["step"] == 0 and state.opt["step"] == 1


# --------------------------------- card: MegaScope and MegaFBD on the kernels ---


@pytest.mark.gpu
def test_probes_leave_qwen2_losses_and_kernel_launches_unchanged(cuda):
    """Two qwen2 smoke train steps on the card with probes on the widest
    tags and without: the losses are bit-identical and K1 and K2 launch
    as often (a tag keeps its tensor on the kernel path); the captures are
    finite, stacked over the layers."""
    from repro_torch.configs import get_config
    from repro_torch.core.scope import ProbeSpec, ScopeCollector
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.train.optim import OptimizerConfig
    from repro_torch.train.train_step import copy_state, init_train_state, make_train_step

    cfg = get_config("qwen2-0.5b", smoke=True)
    state = init_train_state(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
             for k in ("tokens", "targets")}
    ocfg = OptimizerConfig(warmup_steps=1, total_steps=2)
    col = ScopeCollector(probes=[ProbeSpec(p, c) for p, c in (
        ("mlp_hidden", "stats"), ("att_resid", "stats"), ("q", "channels"),
        ("attn_out", "hist"))])
    out = {}
    for name, kw in (("probed", dict(collector=col)), ("plain", {})):
        s = copy_state(state)
        step = make_train_step(cfg, ocfg, **kw)
        flash_attention.reset_launches()
        rmsnorm.reset_launches()
        losses = []
        for _ in range(2):
            s, metrics = step(s, batch)
            losses.append(metrics["loss"].item())
        out[name] = (losses, {**flash_attention.launches, **rmsnorm.launches}, metrics)
    assert out["probed"][0] == out["plain"][0]
    assert out["probed"][1] == out["plain"][1] and out["plain"][1]["flash_fwd"] > 0
    caps = out["probed"][2]["captures"]["seg0"]
    assert caps["mlp_hidden.stats"]["mean"].shape == (cfg.num_layers,)
    assert all(torch.isfinite(v).all() for v in caps["att_resid.stats"].values())
    assert int(caps["attn_out.hist"]["hist"].sum()) == \
        cfg.num_layers * 2 * 64 * cfg.num_heads * cfg.head_dim
    assert "captures" not in out["plain"][2]


@pytest.mark.gpu
def test_stats_of_reads_bfloat16_on_the_card_without_a_float32_copy(cuda):
    """``stats_of`` on a bf16 tensor on the card against float64 (each
    statistic within 1e-5 of max(|reference|, 1); the sparsity count exact,
    also for bf16's nearest value to 1e-6, which lies below it), taking
    less memory above its input than a float32 copy would."""
    from repro_torch.core.scope.compress import stats_of

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 4096)).astype(np.float32))
    x.view(-1)[:4] = torch.tensor([1.046875 * 2.0 ** -20, -1e-7, 2e-6, 0.0])
    x = x.to(torch.bfloat16).to(cuda)
    xd = x.double()
    ref = {"mean": xd.mean(), "std": xd.std(correction=0), "min": xd.min(),
           "max": xd.max(), "l2": torch.linalg.vector_norm(xd),
           "sparsity": (xd.abs() < 1e-6).double().mean()}
    stats_of(x)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ours = stats_of(x)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 4 * x.numel()
    for k, v in ref.items():
        assert abs(ours[k].item() - v.item()) <= 1e-5 * max(abs(v.item()), 1.0), k
    n = x.numel()
    assert round(ours["sparsity"].item() * n) == round(ref["sparsity"].item() * n) >= 3


@pytest.mark.gpu
def test_decoupled_grads_are_bit_identical_to_fused_on_the_card(cuda):
    """qwen2-0.5b at full width cut to 2 layers, remat full, on the card:
    ``make_decoupled_step``'s loss and gradients equal
    ``torch.autograd.grad``'s bit for bit, also with the residuals moved to
    host memory and back between fwd and bwd, and its residual bytes the
    hand count (``chip_smoke.fbd_hand_count``: each layer's bf16 input,
    the int64 positions, the final norm's input and float32 rstd, the
    cross entropy's input and float32 mask, three float32 scalars)."""
    from repro_torch.configs import get_config
    from repro_torch.core.fbd import make_decoupled_step
    from repro_torch.models import lm
    from repro_torch.train.optim import leaves
    from repro_torch.train.train_step import compute_params

    cfg = get_config("qwen2-0.5b").replace(num_layers=2, remat="full")
    params = compute_params(lm.init(cfg, seed=0, device=cuda), torch.bfloat16)
    rng = np.random.default_rng(0)
    B, S = 2, 256
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(cuda)
             for k in ("tokens", "targets")}
    flat = [p for _, p in leaves(params)]
    loss_fn = lambda p, b: lm.loss_fn(cfg, p, b)[0]  # noqa: E731
    ref_loss = loss_fn(params, batch)
    ref = torch.autograd.grad(ref_loss, flat)
    D, L = cfg.d_model, cfg.num_layers
    hand = L * B * S * D * 2 + S * 8 + 2 * B * S * D * 2 + 2 * B * S * 4 + 3 * 4
    step = make_decoupled_step(loss_fn)
    for round_trip in (False, True):
        loss, res = step.fwd(params, batch)
        assert res.nbytes == hand
        if round_trip:
            res.to("cpu")
            assert all(t.device.type == "cpu" for t in res.tensors)
            res.to(cuda)
        grads = step.bwd(params, batch, res, torch.ones_like(loss))
        assert torch.equal(loss, ref_loss.detach())
        for (path, g), r in zip(leaves(grads), ref):
            assert torch.equal(g, r), path


# ---------------------------------------- card: MegaDPP, the pipeline step ---


@pytest.mark.gpu
def test_pipelined_qwen2_step_matches_the_fused_step_on_the_card(cuda):
    """The qwen2 smoke loss and gradients on the card through the pipeline
    (pp 2, 2 microbatches, remat full) and fused: loss, grad_norm and
    every leaf's norm within the step check's limits (1e-3 absolute,
    1e-3 and 1e-2 relative: a microbatch runs the products at half the
    fused M, so the bf16 sums may round otherwise), K1 and K2 launched
    as counted for n_micro microbatches (the final norm once); one train
    step each, with and without MegaFBD's decoupled backward, bit for bit
    the same."""
    from repro_torch.configs import get_config
    from repro_torch.core.dpp.executor import build_time_table, make_pipeline_stages
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.models import lm
    from repro_torch.models import pipeline as pl
    from repro_torch.parallel.plan import ParallelPlan, forward_order, resolve_plan
    from repro_torch.train.optim import OptimizerConfig, global_norm, leaves
    from repro_torch.train.train_step import (
        compute_params, copy_state, init_train_state, make_train_step)

    cfg = get_config("qwen2-0.5b", smoke=True).replace(remat="full")
    plan = resolve_plan(ParallelPlan(pp=2, n_micro=2, schedule="1f1b"))
    L, n_micro = cfg.num_layers, plan.n_micro
    params = compute_params(lm.init(cfg, seed=0, device=cuda), torch.bfloat16)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)).to(cuda)
             for k in ("tokens", "targets")}
    layout = pl.pipeline_layout(cfg, plan.pp, plan.n_chunks)
    table = build_time_table(forward_order(plan), plan.pp, plan.n_chunks, n_micro)
    paths, flat = zip(*leaves(params))
    out = {}
    for name in ("fused", "pipelined"):
        flash_attention.reset_launches()
        rmsnorm.reset_launches()
        if name == "fused":
            loss = lm.loss_fn(cfg, params, batch)[0]
        else:
            loss = pl.pipeline_loss(cfg, params, batch, layout=layout, table=table,
                                    stages=make_pipeline_stages(plan.pp, cuda),
                                    n_micro=n_micro)[0]
        grads = dict(zip(paths, torch.autograd.grad(loss, flat)))
        torch.cuda.synchronize()
        out[name] = (loss.item(), grads, {**flash_attention.launches, **rmsnorm.launches})
    assert out["pipelined"][2] == {"flash_fwd": 2 * L * n_micro, "flash_bwd": L * n_micro,
                                   "rmsnorm_fwd": 4 * L * n_micro + 1,
                                   "rmsnorm_bwd": 2 * L * n_micro + 1}
    (lf, gf, _), (lp, gp, _) = out["fused"], out["pipelined"]
    assert np.isfinite(lp) and abs(lp - lf) <= 1e-3
    norm = lambda g: global_norm(  # noqa: E731
        {"/".join(p): v for p, v in g.items()}).item()
    assert abs(norm(gp) - norm(gf)) <= 1e-3 * norm(gf)
    for p in paths:
        a, b = gp[p].float().norm().item(), gf[p].float().norm().item()
        assert abs(a - b) <= 1e-2 * b + 1e-6, p

    ocfg = OptimizerConfig(warmup_steps=1, total_steps=2)
    state = init_train_state(cfg, seed=0, device=cuda)
    res = {}
    for fbd in (False, True):
        p = resolve_plan(ParallelPlan(pp=2, n_micro=2, fbd_backward=fbd))
        s, m = make_train_step(cfg, ocfg, plan=p)(copy_state(state), batch)
        res[fbd] = (m["loss"], s.master)
    assert torch.equal(res[True][0], res[False][0])
    for (_, a), (_, b) in zip(leaves(res[True][1]), leaves(res[False][1])):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,smoke", [("qwen2-0.5b", False), ("recurrentgemma-9b", True)])
def test_slot_export_import_round_trip_on_the_card(cuda, arch, smoke):
    """MegaRoute's migration unit on the card: a slot's blocks exported from
    one pool, imported at other blocks and another slot of a second pool,
    then exported back, are ``torch.equal`` to the first bundle (the null
    block's padding rows aside), and equal the CPU's export of the same
    values; qwen2-0.5b at full width (paged leaves), Griffin's smoke config
    for its slot-state leaves too."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.paged_cache import PagedKVCache, PoolSpec

    cfg = get_config(arch, smoke=smoke)
    spec = PoolSpec(num_slots=3, num_blocks=40, block_size=16, max_blocks=8)
    gen = torch.Generator(device=cuda).manual_seed(0)

    def fill(kv):
        lm.tree_map(lambda t: t.copy_(torch.randn(t.shape, generator=gen, device=cuda)),
                    kv.pool)
        return kv

    a, b = (fill(PagedKVCache(cfg, spec, cuda)) for _ in range(2))
    phys = torch.tensor([3, 17, 5, 0], dtype=torch.int32, device=cuda)
    phys2 = torch.tensor([30, 2, 11, 0], dtype=torch.int32, device=cuda)
    bundle = a.export_slot(a.pool, phys, 2)
    b.import_slot(b.pool, bundle, phys2, 0)
    back = b.export_slot(b.pool, phys2, 0)
    cpu = PagedKVCache(cfg, spec, torch.device("cpu"))
    cpu_pool = lm.tree_map(lambda t: t.cpu(), a.pool)
    ref = cpu.export_slot(cpu_pool, phys.cpu(), 2)
    flags = lm.tree_leaves(a.paged)
    for paged, x, y, z in zip(flags, lm.tree_leaves(bundle), lm.tree_leaves(back),
                              lm.tree_leaves(ref)):
        assert x.is_cuda and torch.equal(x.cpu(), z)
        if paged:
            x, y = x[:, :3], y[:, :3]
        assert torch.equal(x, y)


# ------------------------------- card: the vocabulary split, one process ---


@pytest.mark.gpu
def test_vocab_parallel_cross_entropy_equals_the_fused_one_on_the_card(cuda):
    """phi3.5-moe's head at full width on the card (d_model 4096, vocabulary
    32064 padded to 32256: the 192 masked columns in the second slice), in
    bf16: the cross entropy and the embedding split over two vocabulary
    slices in one process (``models.split.make_split``, no group) against
    the fused ones on the same inputs.  The loss within rtol 1e-5, ``dy``
    and the head's gradient row by row within 2^-6 of the fused (both
    round to bf16 once, from a ``dlog`` each rounds to bf16 from its own
    float32 softmax), the embedding and its gradient bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.split import WHOLE, make_split

    cfg = get_config("phi3.5-moe-42b-a6.6b")
    split = make_split(cfg, 2)
    assert cfg.padded_vocab - cfg.vocab_size == 192
    assert split.vocab_range(cfg, 1) == (cfg.padded_vocab // 2, cfg.padded_vocab)
    g = torch.Generator(device=cuda).manual_seed(0)
    B, S, D = 2, 1024, cfg.d_model
    y = torch.randn(B, S, D, device=cuda, generator=g).to(torch.bfloat16)
    w = (torch.randn(D, cfg.padded_vocab, device=cuda, generator=g) * D ** -0.5).to(torch.bfloat16)
    emb = torch.randn(cfg.padded_vocab, D, device=cuda, generator=g).to(torch.bfloat16)
    t = torch.randint(0, cfg.vocab_size, (B, S), device=cuda, generator=g, dtype=torch.int32)
    t[0, :4] = torch.tensor([0, cfg.padded_vocab // 2 - 1, cfg.padded_vocab // 2,
                             cfg.vocab_size - 1], device=cuda, dtype=torch.int32)
    mask = (torch.rand(B, S, device=cuda, generator=g) > 0.1).float()
    out = {}
    for name, sp in (("fused", WHOLE), ("split", split)):
        yy, ww, ee = (a.detach().requires_grad_(True) for a in (y, w, emb))
        total, count = L.chunked_xent({"unembed": ww}, cfg, yy, t, mask, sp)
        x = L.embed_apply({"embedding": ee}, cfg, t, torch.bfloat16, sp)
        dy, dw = torch.autograd.grad(total / count, (yy, ww))
        (de,) = torch.autograd.grad(x.float().square().sum(), (ee,))
        out[name] = (total / count, dy, dw, x, de)
    (lf, dyf, dwf, xf, def_), (ls, dys, dws, xs, des) = out["fused"], out["split"]
    torch.testing.assert_close(ls, lf, rtol=1e-5, atol=0)
    assert _row_err(dys, dyf) <= 2.0 ** -6
    assert _row_err(dws, dwf) <= 2.0 ** -6
    assert torch.equal(xs, xf) and torch.equal(des, def_)


# ---------------- card: the tensor split over MLA and the encoder-decoder ---


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "seamless-m4t-large-v2"])
def test_one_process_split_equals_the_fused_kernel_step_on_the_card(cuda, arch):
    """The smoke config's loss and gradients on the card through the kernels
    (K2 past ``attn_kv_chunk`` at seq 64; K1 on deepseek's norms and MLA's
    latent), split over two tensor slices in one process
    (``models.split.make_split``, no group: MLA's heads, the shared and
    routed experts, the dense first layer; the encoder's, the decoder's and
    the cross attention's heads), against the fused ones from the same
    bf16 parameters and batch, MoE's routing pinned to the fused run's:
    the loss within 1e-3, the global gradient norm within 1e-3 and every
    leaf's within 1e-2 of the fused (``chip_smoke.py``'s step limits); each
    slice launches K2 for its heads, so the split launches it twice as
    often."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import layers as L
    from repro_torch.models.model import get_model, make_batch
    from repro_torch.models.split import make_split
    from repro_torch.train.optim import global_norm, leaves
    from repro_torch.train.train_step import compute_params, grad_tree, unused_leaves

    cfg = get_config(arch, smoke=True).replace(remat="none")
    model = get_model(cfg)
    params = compute_params(model.init(cfg, seed=0, device=cuda), torch.bfloat16)
    for _, leaf in leaves(params):
        leaf.requires_grad_(True)
    batch = make_batch(cfg, 2, 64, np.random.default_rng(0), device=cuda)
    picks, real = [], L._top_k

    def record(probs, k):
        vals, idx = real(probs, k)
        picks.append(idx)
        return vals, idx

    def replay(probs, k):
        idx = picks.pop(0)
        return probs.gather(-1, idx), idx

    out = {}
    for name, split, top_k in (("fused", None, record), ("split", make_split(cfg, 2), replay)):
        flash_attention.reset_launches()
        L._top_k = top_k
        try:
            loss, _ = model.loss_fn(cfg, params, batch, split=split)
            grads = grad_tree(params, loss, unused_leaves(cfg))
        finally:
            L._top_k = real
        torch.cuda.synchronize()
        out[name] = (loss.item(), global_norm(grads).item(),
                     {p: g.float().norm().item() for p, g in leaves(grads)},
                     flash_attention.launches["flash_fwd"])
    assert not picks
    (lf, gf, nf, kf), (ls, gs, ns, ks) = out["fused"], out["split"]
    assert kf > 0 and ks == 2 * kf
    assert np.isfinite(ls) and abs(ls - lf) <= 1e-3
    assert abs(gs - gf) <= 1e-3 * gf
    for path, v in nf.items():
        assert abs(ns[path] - v) <= 1e-2 * v + 1e-6, (path, ns[path], v)
