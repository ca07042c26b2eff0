"""Plain PyTorch versions of the WKV6 kernel (K5), forward and backward.

``wkv6_plain`` is ``repro.kernels.wkv6.kernel._wkv6_kernel`` in torch ops:
the exact RWKV-6 recurrence from a zero state,

    y_t = r_tᵀ (S_t + diag(u) k_t v_tᵀ),   S_{t+1} = diag(w_t) S_t + k_t v_tᵀ,

evaluated in chunks of ``chunk`` tokens (the last chunk may be shorter, so
any T is taken): pair scores with the exact per-channel decay
``exp(cum_prev_i - cum_s)`` inside a chunk, the bonus diagonal, and the
carried float32 state across chunks.  The decay applied is ``exp`` of the
kernel's clamped log, ``min(log max(w, 1e-37), -1e-6)``.  Built from
differentiable ops, so autograd gives the gradient of exactly that function,
clamps included; ``wkv6_bwd_plain`` is that gradient, what the CUDA backward
is held to on the card.

Layout as ``wkv6_pallas``: r, k, w ``[B*H, T, K]``, v ``[B*H, T, V]``, row
``b*H + h`` for batch b and head h; u is ``[H, K]``, shared by the batch.
y comes back float32, as ``scan_utils.wkv6_chunked`` returns it (the Pallas
kernel rounds it to r's dtype).  Given float64 r, the whole evaluation runs
in float64: the card checks hold the kernels to that, since the float32
chunked form loses digits of its own under brutal decay (cumulative logs of
~-300 within a chunk).
"""

from __future__ import annotations

import torch

CHUNK = 32


def log_decay(w: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's clamped log-decay, in ``dtype``."""
    return torch.clamp(torch.log(torch.clamp(w.to(dtype), min=1e-37)), max=-1e-6)


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *, chunk: int = CHUNK
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (y ``[B*H, T, V]``, final state ``[B*H, K, V]``), float32 (float64
    for float64 r)."""
    BH, T, K = r.shape
    V = v.shape[-1]
    H = u.shape[0]
    if BH % H:
        raise ValueError(f"{BH} rows do not split into heads of {H}")
    B = BH // H
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32

    def heads(t: torch.Tensor) -> torch.Tensor:
        return t.to(ct).reshape(B, H, T, t.shape[-1])

    rf, kf, vf = heads(r), heads(k), heads(v)
    lw = log_decay(w, ct).reshape(B, H, T, K)
    uf = u.to(ct)[None, :, None, :]
    s = torch.zeros((B, H, K, V), dtype=ct, device=r.device)
    ys = []
    for t0 in range(0, T, chunk):
        sl = slice(t0, min(t0 + chunk, T))
        rc, kc, vc, lc = rf[:, :, sl], kf[:, :, sl], vf[:, :, sl], lw[:, :, sl]
        C = rc.shape[2]
        cum = torch.cumsum(lc, dim=2)               # inclusive  [B,H,C,K]
        cum_prev = cum - lc
        diff = cum_prev[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,H,C,C,K]
        pair = (rc[:, :, :, None, :] * kc[:, :, None, :, :]
                * torch.exp(torch.clamp(diff, max=0.0))).sum(-1)
        below = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                      device=r.device), diagonal=-1)
        scores = torch.where(below, pair, 0.0)      # strictly lower triangular
        diag = (rc * uf * kc).sum(-1, keepdim=True)  # bonus term  [B,H,C,1]
        qp = rc * torch.exp(cum_prev)               # decayed queries
        ys.append(scores @ vc + diag * vc + qp @ s)
        a_tot = torch.exp(cum[:, :, -1])            # [B,H,K]
        k_dec = kc * torch.exp(cum[:, :, -1:] - cum)
        s = a_tot[..., None] * s + k_dec.transpose(-1, -2) @ vc
    y = torch.cat(ys, dim=2).reshape(BH, T, V)
    return y, s.reshape(BH, K, V)


def wkv6_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor):
    """``(dr, dk, dv, dw, du)`` of :func:`wkv6_plain` for a cotangent ``dy``
    of y (the final state's is zero, as on the training path), each in its
    input's dtype; du is ``[H, K]``, summed over the batch."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (r, k, v, w, u)]
        y, _ = wkv6_plain(*ins)
        return torch.autograd.grad(y, ins, dy.to(y.dtype))


def _sweeps(lw: torch.Tensor):
    """Per-channel running sums of the log-decay ``lw [..., L, K]`` along
    its token axis, each as the kernels form it by a running sum from one
    end: exclusive prefix ``cp``, inclusive prefix ``cu``, exclusive suffix
    ``sfx`` (summed from the end, so a token near the end carries no
    rounding of the tokens before it) and the total."""
    cu = torch.cumsum(lw, dim=-2)
    return _exclusive(cu), cu, _exclusive(_suffix(lw), reverse=True), cu[..., -1, :]


def _suffix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums along the token axis (-2)."""
    return torch.flip(torch.cumsum(torch.flip(x, [-2]), dim=-2), [-2])


def _exclusive(incl: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix (suffix, ``reverse``) sums shifted by one token, the
    first (last) zero: no token's own term is subtracted back out, which in
    float32 would cancel a large term against the small sum around it."""
    zero = torch.zeros_like(incl[..., :1, :])
    if reverse:
        return torch.cat([incl[..., 1:, :], zero], dim=-2)
    return torch.cat([zero, incl[..., :-1, :]], dim=-2)


def wkv6_bwd_chunked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor, *,
                           chunk: int = 64, sub: int = 16,
                           drop_cross_dw: bool = False):
    """The chunk algebra of ``csrc/wkv6_bwd.cu`` in torch ops, for the tests:
    ``(dr, dk, dv, dw, du)`` as :func:`wkv6_bwd_plain` gives them, in r's
    float type (float32, or float64 for float64 r).

    1. Per chunk of ``chunk`` tokens (the last one zero-padded, decay 1):
       its state contribution ``U_c = (k e^sfx)^T v``, its query product
       ``W_c = (r e^cp)^T dy`` and its decay ``a_c = e^total``.
    2. Two scans over chunks: ``S_{c+1} = a_c S_c + U_c`` from a zero state
       (the state entering each chunk), ``dS_c = a_c dS_{c+1} + W_c`` from a
       zero gradient (the gradient of the state leaving each chunk).
    3. Per chunk, from S_c and dS_{c+1}, the chunk's ``sub``-token
       sub-chunks: a forward sweep of the states entering them, then a
       reverse sweep that carries the state gradient G and computes, per
       sub-chunk, with pair factors ``E[t, s] = e^(cp_t - cu_s)`` (s < t,
       every exponent <= 0): the pair scores A and ``M = dy v^T``; dr, dk,
       dv; and the decay gradient from the pairs (s, t) that span each
       token tau (s < tau < t) only: those inside the sub-chunk (a suffix
       sum over t, then a sum over s), those from a query after tau in the
       sub-chunk to the entering state S, those from a key before tau to
       the leaving gradient G, and those from S to G across the whole
       sub-chunk, ``a * rowsum(S * G)``.  No identity that subtracts
       near-equal sums (FLA's reverse cumsums cancel in float32).

    ``drop_cross_dw`` leaves out that last, sub-chunk-spanning term (the
    test that shows it matters).  du is summed per chunk, then over chunks
    and the batch in a fixed order.
    """
    BH, T, K = r.shape
    V = v.shape[-1]
    H = u.shape[0]
    B = BH // H
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    nc = -(-T // chunk)
    pad = nc * chunk - T

    def padded(t: torch.Tensor) -> torch.Tensor:
        t = t.to(ct)
        return torch.nn.functional.pad(t, (0, 0, 0, pad)).reshape(BH, nc, chunk, -1)

    rf, kf, vf, dyf = padded(r), padded(k), padded(v), padded(dy)
    lw = padded(log_decay(w, ct))       # padding: log-decay 0, decay 1
    uf = u.to(ct).repeat(B, 1)[:, None, :]           # [BH, 1, K]

    # 1. per chunk
    cp, _, sfx, tot = _sweeps(lw)
    U = (kf * torch.exp(sfx)).transpose(-1, -2) @ vf     # [BH, nc, K, V]
    W = (rf * torch.exp(cp)).transpose(-1, -2) @ dyf
    a = torch.exp(tot)                                   # [BH, nc, K]

    # 2. the scans
    S_in, dS_out = torch.empty_like(U), torch.empty_like(W)
    s = torch.zeros((BH, K, V), dtype=ct, device=r.device)
    for c in range(nc):
        S_in[:, c] = s
        s = a[:, c, :, None] * s + U[:, c]
    g = torch.zeros_like(s)
    for c in reversed(range(nc)):
        dS_out[:, c] = g
        g = a[:, c, :, None] * g + W[:, c]

    # 3. per chunk, its sub-chunks
    below = torch.tril(torch.ones((sub, sub), dtype=torch.bool, device=r.device), -1)
    # span[tau, t, s]: s < tau < t
    idx = torch.arange(sub, device=r.device)
    span = (idx[None, None, :] < idx[:, None, None]) & (idx[:, None, None] < idx[None, :, None])
    grads = {n: torch.zeros((BH, nc, chunk, K), dtype=ct, device=r.device)
             for n in ("dr", "dk", "dv", "dlw")}
    du_part = torch.zeros((BH, nc, K), dtype=ct, device=r.device)
    for c in range(nc):
        parts = []
        for j in range(chunk // sub):
            sl = slice(j * sub, (j + 1) * sub)
            parts.append(tuple(t[:, c, sl] for t in (rf, kf, vf, dyf, lw)))
        states, s = [], S_in[:, c]
        for rs, ks, vs, _, ls in parts:
            states.append(s)
            _, _, sf, tt = _sweeps(ls)
            s = torch.exp(tt)[..., None] * s + (ks * torch.exp(sf)).transpose(-1, -2) @ vs
        g = dS_out[:, c]
        for j in reversed(range(len(parts))):
            rs, ks, vs, dys, ls = parts[j]
            s, sl = states[j], slice(j * sub, (j + 1) * sub)
            cp, cu, sf, tt = _sweeps(ls)
            ecp, esf, at = torch.exp(cp), torch.exp(sf), torch.exp(tt)
            diff = cp[:, :, None, :] - cu[:, None, :, :]             # [BH, t, s, K]
            E = torch.where(below[None, :, :, None], torch.exp(torch.clamp(diff, max=0.0)), 0.0)
            M = dys @ vs.transpose(-1, -2)                             # [BH, t, s]
            A = (rs[:, :, None, :] * ks[:, None, :, :] * E).sum(-1)
            Bm = E * M[..., None]
            X = Bm * rs[:, :, None, :] * ks[:, None, :, :]
            dlw_in = torch.einsum("ats,btsk->bak", span.to(ct), X)
            drS = ecp * (dys @ s.transpose(-1, -2))
            dkS = esf * (vs @ g.transpose(-1, -2))
            vdy = (vs * dys).sum(-1, keepdim=True)
            ruk = (rs * uf * ks).sum(-1, keepdim=True)
            grads["dr"][:, c, sl] = (
                drS + (Bm * ks[:, None, :, :]).sum(2) + uf * ks * vdy)
            grads["dk"][:, c, sl] = dkS + (Bm * rs[:, :, None, :]).sum(1) + uf * rs * vdy
            grads["dv"][:, c, sl] = (A.transpose(-1, -2) @ dys
                                     + (ks * esf) @ g + ruk * dys)
            q_side = rs * drS                                          # queries after tau
            k_side = ks * dkS                                          # keys before tau
            dlw = (dlw_in + _exclusive(_suffix(q_side), reverse=True)
                   + _exclusive(torch.cumsum(k_side, 1)))
            if not drop_cross_dw:
                dlw = dlw + at[:, None, :] * (s * g).sum(-1)[:, None, :]
            grads["dlw"][:, c, sl] = dlw
            du_part[:, c] += (rs * ks * vdy).sum(1)
            g = at[..., None] * g + (rs * ecp).transpose(-1, -2) @ dys

    def unpad(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(BH, nc * chunk, -1)[:, :T]

    wf = w.to(ct)
    passes = (wf >= 1e-37) & (torch.log(torch.clamp(wf, min=1e-37)) <= -1e-6)
    dw = torch.where(passes, unpad(grads["dlw"]) / wf, 0.0)
    du = du_part.sum(1).reshape(B, H, K).sum(0)
    return (unpad(grads["dr"]).to(r.dtype), unpad(grads["dk"]).to(k.dtype),
            unpad(grads["dv"]).to(v.dtype), dw.to(w.dtype), du.to(u.dtype))
