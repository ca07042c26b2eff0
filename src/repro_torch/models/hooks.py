"""Introspection hooks threaded through model code (MegaScope attach point),
counterpart of ``repro.models.hooks``.

Model forward functions accept an optional ``Collector``; the default one is
inert (captures nothing, perturbs nothing, launches nothing), so the model
code stays clean and costs nothing when MegaScope is off.
"""

from __future__ import annotations

from typing import Any

import torch


class Collector:
    """No-op probe collector; ``repro_torch.core.scope`` subclasses it."""

    def tag(self, name: str, value: torch.Tensor, **meta: Any) -> torch.Tensor:
        """Observe ``value`` under ``name``; may return a perturbed copy."""
        return value

    def drain(self) -> dict[str, Any]:
        """Return and clear captured (compressed) values.  Called at the end
        of each layer, so a layer's captures leave with its index."""
        return {}

    def aux(self) -> dict[str, Any]:
        return {}


NULL_COLLECTOR = Collector()


class LayerScoped(Collector):
    """Wraps a collector, adding a layer's index to each tag's metadata.

    ``layer`` is the Python int of the layer (JAX passes the scan's traced
    index); ``site`` names the block's place in its segment's repeating
    pattern (``"seg{i}/b{j}"``), which keys perturbation draws.  Once the
    layer's forward has drained it, :meth:`close` turns recording off: a
    recompute of the layer in the backward (``torch.utils.checkpoint``)
    tags again, and must perturb alike but capture nothing.
    """

    def __init__(self, inner: Collector, layer: int, site: str = ""):
        self.inner = inner
        self.layer = layer
        self.site = site
        self.recording = True

    def tag(self, name: str, value: torch.Tensor, **meta: Any) -> torch.Tensor:
        return self.inner.tag(name, value, layer=self.layer, site=self.site,
                              record=self.recording, **meta)

    def drain(self) -> dict[str, Any]:
        return self.inner.drain()

    def close(self) -> None:
        self.recording = False

    def aux(self) -> dict[str, Any]:
        return self.inner.aux()
