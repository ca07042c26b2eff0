"""Gradient compression with error feedback, counterpart of
``repro.ft.compress``.

int8 block quantization applied to the gradient before the optimizer: 4x
fewer gradient-sync bytes at the bf16 baseline.  The quantization residual
is carried in an error-feedback buffer and re-added next step, which keeps
SGD/Adam convergence (Karimireddy et al.).  The arithmetic is JAX's, leaf
by leaf on the port's dict trees of tensors, so the quantize-dequantize of
a float32 input is bit-identical: per-block scales of ``max |x| / 127``
(1 for an all-zero block), round half to even (``torch.round``, as
``jnp.round``), the last block padded with zeros, the result cast back to
the gradient's dtype.  It is plain PyTorch: JAX computes it in ``jnp``,
outside any Pallas kernel.

``wire_bytes`` is JAX's account of the bytes a compressed sync would move
(int8 values plus a float32 scale a block, against bf16); it measures no
traffic.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.train.optim import leaves, tree_map


@dataclass(frozen=True)
class GradCompressor:
    block: int = 256
    bits: int = 8

    def init(self, params: dict) -> dict:
        """Zero float32 error-feedback buffers shaped like ``params``."""
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def _qdq(self, g: torch.Tensor) -> torch.Tensor:
        """Quantize-dequantize one tensor with per-block scales."""
        levels = 2 ** (self.bits - 1) - 1
        flat = g.reshape(-1).to(torch.float32)
        pad = (-flat.numel()) % self.block
        flat = torch.nn.functional.pad(flat, (0, pad))
        blk = flat.reshape(-1, self.block)
        scale = blk.abs().amax(dim=1, keepdim=True) / levels
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        q = torch.clamp(torch.round(blk / scale), -levels, levels)
        deq = (q * scale).reshape(-1)[: g.numel()].reshape(g.shape)
        return deq.to(g.dtype)

    @torch.no_grad()
    def apply(self, grads: dict, err: dict) -> tuple[dict, dict]:
        """Returns (compressed grads, in each gradient's dtype, and the new
        float32 error buffers)."""
        comp: dict = {}
        new_err: dict = {}
        for path, g in leaves(grads):
            e = err
            for k in path:
                e = e[k]
            gf = g.to(torch.float32) + e
            deq = self._qdq(gf)
            c, n = comp, new_err
            for k in path[:-1]:
                c, n = c.setdefault(k, {}), n.setdefault(k, {})
            c[path[-1]] = deq.to(g.dtype)
            n[path[-1]] = gf - deq
        return comp, new_err

    def wire_bytes(self, grads: dict) -> tuple[int, int]:
        """(compressed, bf16-baseline) gradient-sync byte volumes."""
        sizes = [g.numel() for _, g in leaves(grads)]
        n = sum(sizes)
        n_scales = sum(-(-s // self.block) for s in sizes)
        return n * self.bits // 8 + n_scales * 4, n * 2
