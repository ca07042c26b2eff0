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
