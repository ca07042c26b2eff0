"""Plain PyTorch versions of the RMSNorm kernel (K1), forward and backward.

``rmsnorm_plain`` is ``repro.kernels.rmsnorm.ref.rmsnorm_ref`` (and the
rmsnorm branch of ``repro.models.layers.norm_apply``) operation for
operation: float32 inside, ``y = x * rsqrt(mean(x^2) + eps) * scale``, the
result in x's dtype.  Built from differentiable ops, so autograd gives the
gradient ``jax.grad`` gives.  ``rmsnorm_bwd_plain`` writes that gradient out
(``dx = rstd * (dy*s - xhat * mean(dy*s*xhat))``, ``dscale = sum(dy*xhat)``
in float32): what the CUDA backward is held to on the card.
"""

from __future__ import annotations

import torch


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                      eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dscale)`` for ``y = rmsnorm_plain(x, scale, eps)`` and
    cotangent ``dy``; x and dy ``[..., D]``, scale ``[D]``."""
    D = x.shape[-1]
    xf = x.float().reshape(-1, D)
    g = dy.float().reshape(-1, D)
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    xhat = xf * rstd
    gs = g * scale.float()
    dx = rstd * (gs - xhat * (gs * xhat).mean(-1, keepdim=True))
    dscale = (g * xhat).sum(0)
    return dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype)
