"""The recurrences of the recurrent families with a carried state, token
shift and the causal depthwise convolution, counterparts of
``repro.models.scan_utils``.

The state-free training recurrences are the K5 and K6 kernels
(``kernels/wkv6``, ``kernels/rglru``).  What the JAX package runs outside
Pallas, serving's prefill and decode with a carried state, is here in plain
PyTorch, as XLA runs it there:

* :func:`wkv6_sequential`: the exact per-token WKV recurrence (decode, and
  prefill segments whose width is not a multiple of :data:`WKV_CHUNK`);
* :func:`wkv6_chunked`: the chunk form with per-step log decay clamped to
  ``[-WKV_CLAMP, -1e-6]`` (segments of 32 or more), so a served stream
  changes with the segment widths exactly as JAX's does;
* :func:`lru_scan`: the exact diagonal recurrence through two levels of
  associative scans, with JAX's chunk rule;
* :func:`causal_conv1d` with a carried context, returning ``(y,
  new_prev)``.

:func:`associative_scan` copies ``jax.lax.associative_scan``'s recursion
(pairs combined, the odd half scanned, the even half filled in), so the
float32 sums are grouped as JAX groups them.  The JAX token shift works
within shard-aligned chunks plus a halo column; its values are those of the
plain concat below, which is all one card needs.
"""

from __future__ import annotations

from typing import Callable

import torch

WKV_CHUNK = 32
WKV_CLAMP = 2.0  # max |log decay| per step used by the chunked path


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[0], b[0], a[1], b[1], ...`` along dim 0 (``len(a)`` is
    ``len(b)`` or one more)."""
    out = torch.empty((a.shape[0] + b.shape[0], *a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan(fn: Callable, elems: tuple[torch.Tensor, ...],
                     dim: int) -> tuple[torch.Tensor, ...]:
    """Inclusive scan of ``elems`` along ``dim`` under the associative
    ``fn(x, y)`` (tuples in, a tuple out), grouped as
    ``jax.lax.associative_scan`` groups it."""

    def scan(xs):
        n = xs[0].shape[0]
        if n < 2:
            return xs
        odd = scan(fn(tuple(e[0:n - 1:2] for e in xs),
                      tuple(e[1::2] for e in xs)))
        if n % 2 == 0:
            even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in xs))
        else:
            even = fn(odd, tuple(e[2::2] for e in xs))
        even = tuple(torch.cat([e[:1], r]) for e, r in zip(xs, even))
        return tuple(_interleave(e, o) for e, o in zip(even, odd))

    moved = tuple(e.movedim(dim, 0) for e in elems)
    return tuple(r.movedim(0, dim) for r in scan(moved))


def wkv6_sequential(
    r: torch.Tensor,   # [B, S, H, K]
    k: torch.Tensor,   # [B, S, H, K]
    v: torch.Tensor,   # [B, S, H, V]
    w: torch.Tensor,   # [B, S, H, K] decay in (0, 1)
    u: torch.Tensor,   # [H, K] bonus
    state: torch.Tensor | None = None,  # [B, H, K, V]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-token recurrence (the decode path), in float32:

        y_t = r_t^T (S_t + (u * k_t) v_t^T);  S_{t+1} = diag(w_t) S_t + k_t v_t^T
    """
    B, S, H, K = r.shape
    V = v.shape[-1]
    f32 = torch.float32
    s = (torch.zeros((B, H, K, V), dtype=f32, device=r.device)
         if state is None else state.float())
    r, k, v, w = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]            # [B,H,K,V]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + uf * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv6_chunked(
    r: torch.Tensor,   # [B, S, H, K]
    k: torch.Tensor,
    v: torch.Tensor,   # [B, S, H, V]
    w: torch.Tensor,   # [B, S, H, K]
    u: torch.Tensor,   # [H, K]
    state: torch.Tensor | None = None,  # [B, H, K, V]
    chunk: int = WKV_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel WKV: the matmul form within a chunk, an associative
    scan across chunks; the sequential form when ``S`` is not a multiple of
    ``chunk``.  The per-step log decay is clamped to ``[-WKV_CLAMP,
    -1e-6]`` so that the chunk's exponentials stay in float32 range."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    if S % chunk != 0:
        return wkv6_sequential(r, k, v, w, u, state)
    nc, C = S // chunk, chunk
    f32 = torch.float32
    rc = r.reshape(B, nc, C, H, K).float()
    kc = k.reshape(B, nc, C, H, K).float()
    vc = v.reshape(B, nc, C, H, V).float()
    lw = torch.clamp(torch.log(w.reshape(B, nc, C, H, K).float()),
                     -WKV_CLAMP, -1e-6)
    cum = torch.cumsum(lw, dim=2)  # inclusive cumulative log decay
    cum_prev = cum - lw            # exclusive

    qp = rc * torch.exp(cum_prev)  # decayed queries
    kp = kc * torch.exp(-cum)      # inverse-decayed keys

    # intra-chunk pair contributions (strictly lower triangular) + diagonal u
    scores = torch.einsum("bnihk,bnjhk->bnhij", qp, kp)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    scores = torch.where(tri, scores, 0.0)
    diag = torch.einsum("bnihk,hk,bnihk->bnhi", rc, u.float(), kc)
    y_intra = torch.einsum("bnhij,bnjhv->bnihv", scores, vc)
    y_intra = y_intra + diag[..., None].permute(0, 1, 3, 2, 4) * vc

    # chunk summaries: total decay + decayed key-value outer products
    a_chunk = torch.exp(cum[:, :, -1])                  # [B,nc,H,K]
    k_dec = kc * torch.exp(cum[:, :, -1:] - cum)        # decay to chunk end
    m_chunk = torch.einsum("bnjhk,bnjhv->bnhkv", k_dec, vc)

    # across chunks: (a, M) o (a', M') = (a a', a'[:, None] M + M')
    def combine(x, y):
        (ax, mx), (ay, my) = x, y
        return ax * ay, ay[..., None] * mx + my

    a_in, m_in = associative_scan(combine, (a_chunk, m_chunk), dim=1)
    s0 = (state.float() if state is not None
          else torch.zeros((B, H, K, V), dtype=f32, device=r.device))
    a_ex = torch.cat([torch.ones_like(a_in[:, :1]), a_in[:, :-1]], dim=1)
    m_ex = torch.cat([torch.zeros_like(m_in[:, :1]), m_in[:, :-1]], dim=1)
    s_in = a_ex[..., None] * s0[:, None] + m_ex         # [B,nc,H,K,V]

    y_carry = torch.einsum("bnihk,bnhkv->bnihv", qp, s_in)
    y = (y_intra + y_carry).reshape(B, S, H, V)
    final_state = a_in[:, -1, ..., None] * s0 + m_in[:, -1]
    return y, final_state


def lru_scan(
    a: torch.Tensor,   # [B, S, W] per-step decay in (0, 1)
    b: torch.Tensor,   # [B, S, W] per-step input
    h0: torch.Tensor | None = None,  # [B, W]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact diagonal linear recurrence ``h_t = a_t h_{t-1} + b_t`` via two
    levels of associative scans (chunks of 128, or one chunk of ``S`` below
    128, else one level over ``S``).  Returns ``(h [B, S, W], h_last)``."""
    B, S, W = a.shape
    a, b = a.float(), b.float()

    def combine(x, y):
        (ax, bx), (ay, by) = x, y
        return ax * ay, ay * bx + by

    chunk = 128 if S % 128 == 0 else (S if S < 128 else 1)
    if chunk > 1 and S % chunk == 0:
        nc = S // chunk
        a_c, h_c = associative_scan(
            combine, (a.reshape(B, nc, chunk, W), b.reshape(B, nc, chunk, W)),
            dim=2)
        a_in, h_in = associative_scan(combine, (a_c[:, :, -1], h_c[:, :, -1]),
                                      dim=1)
        a_ex = torch.cat([torch.ones_like(a_in[:, :1]), a_in[:, :-1]], dim=1)
        h_ex = torch.cat([torch.zeros_like(h_in[:, :1]), h_in[:, :-1]], dim=1)
        if h0 is not None:
            h_ex = h_ex + a_ex * h0[:, None].float()
        h = (h_c + a_c * h_ex[:, :, None]).reshape(B, S, W)
    else:
        a_in, h = associative_scan(combine, (a, b), dim=1)
        if h0 is not None:
            h = h + a_in * h0[:, None].float()
    return h, h[:, -1]


def shift_tokens(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """The x_{t-1} stream: ``[B, S, D] -> [B, S, D]``; position 0 sees
    ``prev`` ``[B, D]`` (or zeros)."""
    first = (prev[:, None].to(x.dtype) if prev is not None
             else torch.zeros_like(x[:, :1]))
    return torch.cat([first, x[:, :-1]], dim=1)


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None,
                  prev: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal convolution ``[B, S, W] -> [B, S, W]`` with taps
    ``weight [width, W]`` (tap 0 the current token) after the carried
    context ``prev [B, width - 1, W]`` (zeros when None).  Returns ``(y,
    new_prev)``: the last ``width - 1`` inputs, context included where
    ``S < width - 1``.

    Written as the JAX function writes it, in x's dtype with the context,
    the taps and the bias cast to it: tap 0 times x, then for each further
    tap one more token shift (position 0 seeing the context's column for
    that tap) and its product added, the bias last.  Not ``F.conv1d``, which
    sums in another order and on the card runs through cuDNN in TF32 by
    default.
    """
    B, S, W = x.shape
    width = weight.shape[0]
    dt = x.dtype
    ctx = (prev.to(dt) if prev is not None
           else torch.zeros((B, width - 1, W), dtype=dt, device=x.device))
    y = weight[0].to(dt) * x
    shifted = x
    for i in range(1, width):
        shifted = shift_tokens(shifted, ctx[:, width - 1 - i])
        y = y + weight[i].to(dt) * shifted
    if bias is not None:
        y = y + bias.to(dt)
    if S >= width - 1 and width > 1:
        new_prev = x[:, S - (width - 1):]
    else:
        new_prev = torch.cat([ctx, x], dim=1)[:, -(width - 1):]
    return y, new_prev
