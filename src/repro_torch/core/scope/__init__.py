"""MegaScope on the port: probes, perturbations, PCA, generation records and
the dashboard, counterpart of ``repro.core.scope``."""

from repro_torch.core.scope.collector import PerturbSpec, ProbeSpec, ScopeCollector
from repro_torch.core.scope.compress import COMPRESSORS, stats_of
from repro_torch.core.scope.pca import pca_fit, pca_project
from repro_torch.core.scope.generation import GenerationRecord, generate_with_scope
from repro_torch.core.scope.dashboard import write_dashboard

__all__ = [
    "ProbeSpec",
    "PerturbSpec",
    "ScopeCollector",
    "COMPRESSORS",
    "stats_of",
    "pca_fit",
    "pca_project",
    "GenerationRecord",
    "generate_with_scope",
    "write_dashboard",
]
