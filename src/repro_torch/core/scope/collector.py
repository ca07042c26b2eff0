"""MegaScope probe collector + perturbation injection (§6.1-6.2), counterpart
of ``repro.core.scope.collector``.

Probes are registered declaratively (observation points = tag-name patterns
+ compression mode); the collector is threaded through the model as a
``repro_torch.models.hooks.Collector``, and each layer drains its compressed
captures, which ``lm.forward`` stacks over the layer axis.  Compressors run
under ``torch.no_grad`` on the device: a capture is an observation, never
part of the gradient, and nothing is read back to the host here.

Perturbations implement the paper's controlled experiments:
  * ``gaussian``  — additive noise (reduced-precision emulation)
  * ``bitflip``   — random bit flips of the binary representation
  * ``offset``    — constant shift on inter-layer tensors
  * ``zero_mask`` — channel masking
  * ``attn_uniform`` — mix attention probabilities toward uniform weights

Every tag perturbs before it probes, as in the JAX package.  Random draws
come from a ``torch.Generator`` of their own, never the global RNG, seeded
from the collector's ``seed``, its ``epoch``, the perturbation's index, the
tag's name and its block's ``site`` (``"seg{i}/b{j}"``), not from a running
counter.  So, as the JAX package's traced scan body does, every layer of a
segment shares one draw per site, every train step repeats it, a recompute
of a layer in the backward (remat) gets the very noise its forward drew, and
``generate_with_scope`` draws anew per forward call (:meth:`new_draws`).
"""

from __future__ import annotations

import fnmatch
import hashlib
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core.scope.compress import COMPRESSORS
from repro_torch.models.hooks import Collector


@dataclass(frozen=True)
class ProbeSpec:
    pattern: str                  # fnmatch over tag names ("attn_*", "mlp_hidden")
    compress: str = "stats"       # COMPRESSORS key
    kwargs: tuple = ()            # extra args for the compressor


@dataclass(frozen=True)
class PerturbSpec:
    pattern: str
    kind: str                     # gaussian | bitflip | offset | zero_mask | attn_uniform
    amount: float = 0.0           # sigma / flip prob / offset / mask frac
    layer: int | None = None      # None = all layers


class ScopeCollector(Collector):
    def __init__(self, probes: list[ProbeSpec] = (),
                 perturbs: list[PerturbSpec] = (), seed: int = 0):
        self.probes = list(probes)
        self.perturbs = list(perturbs)
        self.seed = seed
        self.epoch = 0
        self._buf: dict[str, Any] = {}

    def new_draws(self) -> None:
        """Make every later draw fresh (a new forward call's noise)."""
        self.epoch += 1

    # ------------------------------------------------------------- capture
    def tag(self, name: str, value: torch.Tensor, *, layer: int | None = None,
            site: str = "", record: bool = True, **meta: Any) -> torch.Tensor:
        for i, spec in enumerate(self.perturbs):
            if fnmatch.fnmatch(name, spec.pattern):
                if spec.layer is None or layer is None or layer == spec.layer:
                    value = self._perturb_value(spec, value, (i, name, site))
        if record:
            for spec in self.probes:
                if fnmatch.fnmatch(name, spec.pattern):
                    with torch.no_grad():
                        self._buf[f"{name}.{spec.compress}"] = COMPRESSORS[
                            spec.compress](value.detach(), *spec.kwargs)
        return value

    def drain(self) -> dict[str, Any]:
        out, self._buf = self._buf, {}
        return out

    # ----------------------------------------------------------- perturbs
    def _generator(self, key: tuple, device: torch.device) -> torch.Generator:
        digest = hashlib.sha256(repr((self.seed, self.epoch, *key)).encode()).digest()
        return torch.Generator(device=device).manual_seed(
            int.from_bytes(digest[:8], "little") >> 1)

    def _perturb_value(self, spec: PerturbSpec, value: torch.Tensor,
                       key: tuple) -> torch.Tensor:
        kind, amt = spec.kind, spec.amount
        if kind == "gaussian":
            noise = torch.randn(value.shape, generator=self._generator(key, value.device),
                                dtype=torch.float32, device=value.device)
            return value + amt * noise.to(value.dtype)
        if kind == "offset":
            # the amount rounded to the value's dtype, as jnp.asarray(amt, dtype)
            return value + float(torch.tensor(amt, dtype=value.dtype))
        if kind == "zero_mask":
            u = torch.rand(value.shape[-1:], generator=self._generator(key, value.device),
                           device=value.device)
            return value * (u < 1.0 - amt).to(value.dtype)
        if kind == "bitflip":
            return _bitflip(value, amt, self._generator(key, value.device))
        if kind == "attn_uniform":
            # value: attention probabilities [..., T]; mix toward uniform
            u = torch.ones_like(value) / value.shape[-1]
            return (1.0 - amt) * value + amt * u
        raise ValueError(kind)


def _bitflip(value: torch.Tensor, prob: float, gen: torch.Generator) -> torch.Tensor:
    """Flip each bit of the binary representation with probability ``prob``
    (the paper's storage-fault robustness study).  The bits are the value's
    signed-integer view (torch has no uint16 bit operations on every build);
    XOR does not care.  Like JAX's bitcast, this passes no gradient."""
    if value.dtype == torch.float32:
        idt, nbits = torch.int32, 32
    elif value.dtype in (torch.bfloat16, torch.float16):
        idt, nbits = torch.int16, 16
    else:
        return value
    bits = value.detach().contiguous().view(idt)
    mask = torch.zeros_like(bits)
    for b in range(nbits):
        flip = torch.rand(value.shape, generator=gen, device=value.device) < prob
        mask |= flip.to(idt) << b
    return (bits ^ mask).view(value.dtype)
